#!/usr/bin/env python3
"""Stereo pair -> disparity -> depth PNG on the PyTorch/CUDA port (the CLI
of apps/stereo_depth.py plus ``--device``; reference
datagen/stereo_alg.py).  Pillow reads and writes the PNG files.

    python apps/stereo_depth_torch.py --left l.png --right r.png --out depth.png
    python apps/stereo_depth_torch.py --left l.png --right r.png --out depth.png --device cpu
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from beats3d_tpu_torch.ops import stereo  # noqa: E402


def run(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--left", required=True)
    p.add_argument("--right", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--min_disparity", type=int, default=0)
    p.add_argument("--max_disparity", type=int, default=32)
    p.add_argument("--block_size", type=int, default=11)
    p.add_argument("--depth_scale", type=float, default=100000.0,
                   help="depth = scale / disparity (stereo_alg.py:32)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device: cuda or cpu (the same bits)")
    args = p.parse_args(argv)

    from PIL import Image

    def grayscale(path):
        a = np.asarray(Image.open(path))
        a = a[:, :, 0] if a.ndim == 3 else a  # stereo_alg.py:15-16
        return torch.as_tensor(a.astype(np.float32), device=args.device)

    disp = stereo.block_match_disparity(
        grayscale(args.left), grayscale(args.right),
        min_disparity=args.min_disparity,
        max_disparity=args.max_disparity,
        block_size=args.block_size,
    )
    depth = stereo.depth_from_disparity(disp, args.depth_scale).cpu().numpy()
    Image.fromarray(depth).save(args.out)
    valid = depth > 0
    print(f"depth: {args.out}  valid px {int(valid.sum())}/{depth.size}  "
          f"range [{int(depth[valid].min()) if valid.any() else 0}, "
          f"{int(depth.max())}]")
    return depth


def main(argv=None):
    """The command line and the ``b3d-stereo-depth-torch`` console script:
    :func:`run`, its result dropped (a console script exits with what
    ``main`` returns)."""
    run(argv)


if __name__ == "__main__":
    main()
