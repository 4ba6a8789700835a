#!/usr/bin/env python3
"""Photographed projector tile -> normalized tiled pattern image on the
PyTorch/CUDA port (the CLI of apps/make_proj_image.py plus ``--device``;
reference datagen/make_proj_image.py).  Pillow reads and writes the PNG
files.

    python apps/make_proj_image_torch.py --src l2_green.png \
        --corners 884,417 976,567 1124,458 1028,304 --out pattern.png
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402

from beats3d_tpu_torch.ops.warp import make_projector_pattern  # noqa: E402


def run(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--src", required=True)
    p.add_argument("--corners", nargs=4, required=True,
                   help="four x,y corners of the tile in the photo "
                        "(make_proj_image.py:10-13 order)")
    p.add_argument("--out", required=True)
    p.add_argument("--tile_size", type=int, default=100)
    p.add_argument("--num_tiles", type=int, default=20)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of the warp: cuda or cpu (the same "
                        "bits)")
    args = p.parse_args(argv)

    from PIL import Image

    pts = np.array([[float(v) for v in c.split(",")] for c in args.corners])
    img = np.asarray(Image.open(args.src).convert("RGB"))
    out = make_projector_pattern(
        img, pts, tile_size=args.tile_size, num_tiles=args.num_tiles,
        device=args.device)
    Image.fromarray(out).save(args.out)
    print(f"pattern: {args.out}  {out.shape[1]}x{out.shape[0]}")
    return out


def main(argv=None):
    """The command line and the ``b3d-make-proj-image-torch`` console
    script: :func:`run`, its result dropped (a console script exits with
    what ``main`` returns)."""
    run(argv)


if __name__ == "__main__":
    main()
