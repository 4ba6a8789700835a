#!/usr/bin/env python3
"""Single (non-layered) forest live demo on the PyTorch/CUDA port, headless
(the CLI of apps/run_live.py plus ``--device``): plane-band-filtered depth
through one forest, label histograms out.

Example:
  python apps/run_live_torch.py -m model.npy --synthetic --frames 300
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from beats3d_tpu_torch.models import DecisionForest  # noqa: E402
from beats3d_tpu_torch.ops import plane as plane_ops, points  # noqa: E402
from beats3d_tpu_torch.ops.forest_eval_cuda import evaluate_forest_cuda  # noqa: E402
from beats3d_tpu_torch.runtime import camera  # noqa: E402
from beats3d_tpu_torch.utils.profiler import FrameTimeLog  # noqa: E402

MAX_UINT16 = 65535


def frame_labels(depth, mat, pp, fx, forest, threshold):
    """(H, W) depth -> (H, W) labels of one forest: pixels missing or in the
    table band become 65535 for the forest (the JAX app's deproject ->
    transform -> plane filter -> setup_depth_image_for_forest chain, fused
    by points.plane_band_depth), then the forest at full resolution."""
    d = points.plane_band_depth(depth.to(torch.int32), mat, pp, fx, threshold)
    d = torch.where(d == 0, MAX_UINT16, d)
    return evaluate_forest_cuda(d[None].contiguous(), forest)[0]


def main():
    parser = argparse.ArgumentParser(description="Live RDF demo (PyTorch/CUDA)")
    parser.add_argument("-m", "--model", required=True, type=str,
                        help=".npy forest model")
    parser.add_argument("--plane_num_iterations", type=int, default=25000)
    parser.add_argument("--plane_z_threshold", type=float, default=40.0)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device: cuda (the CUDA kernel) or cpu "
                             "(its plain version)")
    camera.add_args(parser)
    args = parser.parse_args()

    dev = torch.device(args.device)
    source = camera.open_source(args)
    intrin = source.intrinsics
    forest = torch.as_tensor(DecisionForest.load(args.model).data, device=dev)
    cal = plane_ops.CalibratedPlane(
        args.plane_num_iterations, args.plane_z_threshold, device=dev)

    ft = FrameTimeLog()
    n = 0
    try:
        for frame in source.frames():
            ft.tick()
            n += 1
            if n <= 15:
                continue
            depth = torch.as_tensor(frame.depth.astype(np.int32), device=dev)
            if not cal.is_set():
                cal.make(points.deproject_points(depth, intrin.pp, intrin.fx))
            labels = frame_labels(depth, cal.get_mat(), intrin.pp, intrin.fx,
                                  forest, args.plane_z_threshold)
            if n % 30 == 0:
                hist = np.unique(labels.cpu().numpy(), return_counts=True)
                print(f"frame {n}: {ft.last_ms:.1f} ms/frame, labels "
                      f"{dict(zip(hist[0].tolist(), hist[1].tolist()))}")
            if args.frames and n >= args.frames:
                break
    finally:
        source.stop()


if __name__ == "__main__":
    main()
