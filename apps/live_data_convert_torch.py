#!/usr/bin/env python3
"""Convert a recorded (depth + colour) session into RDF training data with
the PyTorch/CUDA port (beats3d_tpu_torch): the CLI of
apps/live_data_convert.py plus ``--device``.  The per-frame work runs on
the card (the mask model through kernel B1) unless ``--device cpu``;
writing the PNGs needs Pillow.

Example:
  python apps/live_data_convert_torch.py --session s.npz -o ds/ --colors 6 \\
      --plane_z_threshold 40 --mask_model models/flagship/m0.npy \\
      --mask_label 1 --gaussian_noise 1.5 --seed 3
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402

from beats3d_tpu_torch.data.datagen import (  # noqa: E402
    DatagenConfig, LiveDataConvert,
)
from beats3d_tpu_torch.models import DecisionForest  # noqa: E402
from beats3d_tpu_torch.runtime import camera  # noqa: E402


def run(argv=None):
    parser = argparse.ArgumentParser(
        description="Convert a recorded session into training data for RDF "
                    "(PyTorch/CUDA)"
    )
    parser.add_argument("-i", "--bag_in", type=str, default=None,
                        help="RealSense .bag input (needs pyrealsense2)")
    parser.add_argument("--session", type=str, default=None,
                        help=".npz recorded session input")
    parser.add_argument("-o", "--out", required=True, type=str)
    parser.add_argument("--colors", required=True, type=int,
                        help="Num colors to fit for labels")
    parser.add_argument("--plane_z_threshold", required=True, type=float)
    parser.add_argument("--max_images", type=int, default=None)
    parser.add_argument("--frames_timestamp_max_diff", type=float, default=6.0)
    parser.add_argument("--mask_model", type=str, default=None)
    parser.add_argument("--mask_label", type=int, default=None)
    parser.add_argument("--gaussian_noise", type=float, default=0.0)
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device: cuda (the CUDA kernels) or cpu "
                             "(their plain versions)")
    args = parser.parse_args(argv)

    if bool(args.mask_model) != bool(args.mask_label):
        parser.error("--mask_model and --mask_label are both required together")

    if args.session:
        source = camera.RecordedSource(args.session)
    elif args.bag_in:
        # colour must be reprojected into the depth frame for labelling
        source = camera.RealSenseSource(bag=args.bag_in, align_color=True)
    else:
        parser.error("need --session or --bag_in")

    cfg = DatagenConfig(
        num_colors=args.colors,
        plane_z_threshold=args.plane_z_threshold,
        max_images=args.max_images,
        gaussian_noise=args.gaussian_noise,
        frames_timestamp_max_diff=args.frames_timestamp_max_diff,
        mask_label=args.mask_label,
    )
    mask_model = DecisionForest.load(args.mask_model) if args.mask_model else None
    conv = LiveDataConvert(
        args.out, source.intrinsics, cfg, mask_model=mask_model,
        rng=np.random.default_rng(args.seed), device=args.device,
    )

    for frame in source.frames():
        if frame.color is None:
            continue
        if not conv.process_frame(
            frame.depth, frame.color,
            depth_timestamp=frame.timestamp,
            color_timestamp=frame.color_timestamp,
        ):
            break
    source.stop()
    out_cfg = conv.finish()
    print(
        f"wrote {out_cfg['num_images']} images to {args.out} "
        f"({conv.frames_skipped} pairs rejected by timestamp gate)"
    )
    return conv


def main(argv=None):
    """The command line and the ``b3d-live-data-convert-torch`` console
    script: :func:`run`, its result dropped (a console script exits with
    what ``main`` returns)."""
    run(argv)


if __name__ == "__main__":
    main()
