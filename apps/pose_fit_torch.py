#!/usr/bin/env python3
"""Fit a cylinder to a labelled region by render-and-compare random search
with the PyTorch/CUDA port (beats3d_tpu_torch): the CLI of
apps/pose_fit.py plus ``--device``.  The frame's labels come from one
forest, through kernel B1 on a card (its plain version with
``--device cpu``).

Example:
  python apps/pose_fit_torch.py -m models/flagship/m0.npy --synthetic \\
      --plane_z_threshold 40 --view fit.html
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from beats3d_tpu_torch.models import DecisionForest  # noqa: E402
from beats3d_tpu_torch.ops import meanshift, plane as plane_ops, points  # noqa: E402
from beats3d_tpu_torch.ops.forest_eval_cuda import evaluate_forest_cuda  # noqa: E402
from beats3d_tpu_torch.ops.posefit import (  # noqa: E402
    CylinderTform, cylinder_surface, fit_cylinder,
)
from beats3d_tpu_torch.runtime import camera  # noqa: E402
from beats3d_tpu_torch.utils.orbit_html import write_orbit_html  # noqa: E402


def run(argv=None):
    parser = argparse.ArgumentParser(
        description="Cylinder pose fit (PyTorch/CUDA)")
    parser.add_argument("-m", "--model", required=True, type=str)
    parser.add_argument("--plane_num_iterations", type=int, default=25000)
    parser.add_argument("--plane_z_threshold", required=True, type=float)
    parser.add_argument("--iterations", type=int, default=200)
    parser.add_argument("--target_label", type=int, default=1)
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument(
        "--view", type=str, default=None, metavar="OUT.html",
        help="write an interactive 3D orbit view of the fit: the target-"
             "label point cloud plus the cylinder at each accepted pose")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device: cuda (the CUDA kernel) or cpu "
                             "(its plain version)")
    camera.add_args(parser)
    args = parser.parse_args(argv)

    dev = torch.device(args.device)
    source = camera.open_source(args)
    intrin = source.intrinsics
    model = DecisionForest.load(args.model)
    forest = torch.as_tensor(model.data, device=dev)
    cal = plane_ops.CalibratedPlane(
        args.plane_num_iterations, args.plane_z_threshold, device=dev)

    # skip camera warm-up frames, but tolerate short recorded sessions
    frame = None
    for i, frame in enumerate(source.frames()):
        if i >= 14:
            break
    if frame is None:
        raise SystemExit("no frames in source")
    depth = torch.as_tensor(frame.depth.astype(np.int32), device=dev)
    pts = points.deproject_points(depth, intrin.pp, intrin.fx)
    cal.make(pts)
    mat = cal.get_mat().cpu().numpy()

    q = points.transform_points(pts, cal.get_mat())
    qf = points.filter_points_by_plane(q, args.plane_z_threshold)
    d = points.setup_depth_image_for_forest(qf, depth)
    labels = evaluate_forest_cuda(d[None].contiguous(), forest)[0]

    variances = torch.full((model.num_classes - 1,), 50.0, device=dev)
    means = meanshift.mean_shift(
        labels, variances, num_classes=model.num_classes - 1, num_rounds=6
    ).cpu().numpy()
    px, py = means[args.target_label - 1].astype(int)
    z = float(frame.depth[py, px])
    p = mat @ np.array(
        [
            z * (px - intrin.ppx) / intrin.fx,
            z * (py - intrin.ppy) / intrin.fy,
            z,
            1.0,
        ]
    )

    init = CylinderTform()
    init.t[:] = p[0:3]
    init.s[:] = [200.0 * 1.3, 200.0, 800.0]

    obs = points.remove_missing_3d_points_from_depth_image(qf, depth)
    poses = []
    best, cost, history = fit_cylinder(
        obs, labels, mat, init,
        intrin.pp, intrin.fx,
        target_label=args.target_label,
        iterations=args.iterations,
        rng=np.random.default_rng(args.seed),
        log=print,
        on_improve=lambda i, c, tf: poses.append((i, c, tf)),
        device=dev,
    )
    print(f"final cost {cost:.1f}; t={best.t} r={best.r} s={best.s}")
    if args.view:
        write_fit_view(
            args.view, qf.cpu().numpy(), labels.cpu().numpy(),
            args.target_label, poses,
        )
        print(f"wrote {args.view}")
    source.stop()
    return best, cost, history, poses


def main(argv=None):
    """The command line and the ``b3d-pose-fit-torch`` console script:
    :func:`run`, its result dropped (a console script exits with what
    ``main`` returns)."""
    run(argv)


def write_fit_view(out, qf, labels, target_label, poses, max_obs=25000):
    """Orbit-viewer HTML of the fit: target-label observation cloud (blue)
    + the cylinder surface at up to 6 accepted poses, early poses dim,
    the final pose bright green."""
    sel = (labels == target_label) & (qf[..., 2] != 0)
    cloud = qf[sel][:, :3]
    if cloud.shape[0] > max_obs:
        cloud = cloud[:: cloud.shape[0] // max_obs + 1]
    pts = [cloud]
    cols = ["#4a69bd"] * cloud.shape[0]

    if len(poses) > 6:  # first, last, and 4 spread between
        keep = [0] + list(
            np.linspace(1, len(poses) - 2, 4).astype(int)
        ) + [len(poses) - 1]
        poses = [poses[i] for i in keep]
    surf = cylinder_surface(48, 24)
    shades = ["#5a4630", "#75592f", "#90702c", "#ab8a25", "#c6a718"]
    for k, (_, _, tf) in enumerate(poses):
        final = k == len(poses) - 1
        p = (tf.get_tform() @ surf.T).T[:, :3]
        pts.append(p)
        cols.extend(
            ["#37e06b" if final else shades[min(k, len(shades) - 1)]]
            * p.shape[0]
        )
    info = (
        f"pose_fit: {cloud.shape[0]} label-{target_label} pts, "
        f"{len(poses)} poses (final green), cost "
        f"{poses[-1][1]:.1f}" if poses else "pose_fit: no poses"
    )
    write_orbit_html(out, np.concatenate(pts), cols, info, title="pose_fit")


if __name__ == "__main__":
    main()
