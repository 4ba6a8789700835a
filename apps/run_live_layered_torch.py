#!/usr/bin/env python3
"""Layered-RDF live demo on the PyTorch/CUDA port, headless (the CLI of
apps/run_live_layered.py plus ``--device``): single hand, no grouping or
MIDI; plane-filtered depth through the layered forest (kernel K1 on the
card, once per frame), label renders out.

Examples:
  python apps/run_live_layered_torch.py -cfg models/flagship/model_cfg.json --synthetic --frames 120
  python apps/run_live_layered_torch.py -cfg model/model_cfg.json --rs_bag take.bag
  python apps/run_live_layered_torch.py -cfg model/model_cfg.json --device cpu --synthetic
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from beats3d_tpu_torch.models import LayeredDecisionForest  # noqa: E402
from beats3d_tpu_torch.models.layered import run_layered  # noqa: E402
from beats3d_tpu_torch.ops import plane as plane_ops, points  # noqa: E402
from beats3d_tpu_torch.runtime import camera  # noqa: E402
from beats3d_tpu_torch.utils.profiler import FrameTimeLog  # noqa: E402

TRAIN_DIM_X = 848
LABELS_REDUCE = 2
WARMUP_FRAMES = 15      # camera warm-up (reference run_live_layered.py:74)


def frame_labels(depth, mat, pp, fx, model, threshold, scale_factor):
    """(H, W) int32 depth -> ((H/r, W/r) labels, their RGBA): deproject,
    plane transform, drop the table band, missing -> 65535, then every
    layer of the model and the composite (K1 for a CUDA model)."""
    pts = points.deproject_points(depth, pp, fx)
    q = points.transform_points(pts, mat)
    qf = points.filter_points_by_plane(q, threshold)
    d = points.setup_depth_image_for_forest(qf, depth)
    labels = run_layered(d[None].contiguous(), model,
                         labels_reduce=LABELS_REDUCE,
                         scale_factor=scale_factor)[0]
    return labels, points.make_rgba_from_labels(labels, model.label_colors)


def run(argv=None):
    parser = argparse.ArgumentParser(
        description="Layered RDF demo (PyTorch/CUDA)")
    parser.add_argument("-cfg", required=True, type=str)
    parser.add_argument("--plane_num_iterations", type=int, default=25000)
    parser.add_argument("--plane_z_threshold", type=float, default=40.0)
    parser.add_argument("--out", type=str, default=None,
                        help="directory for label RGBA dumps")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device: cuda (the CUDA kernel) or cpu "
                             "(its plain version)")
    camera.add_args(parser)
    args = parser.parse_args(argv)

    dev = torch.device(args.device)
    source = camera.open_source(args)
    intrin = source.intrinsics
    model = LayeredDecisionForest.load(args.cfg, labels_reduce=LABELS_REDUCE,
                                       device=dev)
    cal = plane_ops.CalibratedPlane(
        args.plane_num_iterations, args.plane_z_threshold, device=dev)
    scale_factor = intrin.width / TRAIN_DIM_X

    ft = FrameTimeLog()
    n = 0
    try:
        for frame in source.frames():
            ft.tick()
            n += 1
            if n <= WARMUP_FRAMES:
                continue
            depth = torch.as_tensor(frame.depth.astype(np.int32), device=dev)
            if not cal.is_set():
                cal.make(points.deproject_points(depth, intrin.pp, intrin.fx))
            labels, rgba = frame_labels(
                depth, cal.get_mat(), intrin.pp, intrin.fx, model,
                args.plane_z_threshold, scale_factor)
            if n % 30 == 0:
                hist = np.unique(labels.cpu().numpy(), return_counts=True)
                print(f"frame {n}: {ft.last_ms:.1f} ms/frame, labels "
                      f"{dict(zip(hist[0].tolist(), hist[1].tolist()))}")
                if args.out:
                    from PIL import Image

                    os.makedirs(args.out, exist_ok=True)
                    Image.fromarray(rgba.cpu().numpy()).save(
                        os.path.join(args.out, f"labels_{n:06d}.png"))
            if args.frames and n >= args.frames:
                break
    finally:
        source.stop()
    return n


def main(argv=None):
    """The command line and the ``b3d-run-live-layered-torch`` console
    script: :func:`run`, its result dropped (a console script exits with
    what ``main`` returns)."""
    run(argv)


if __name__ == "__main__":
    main()
