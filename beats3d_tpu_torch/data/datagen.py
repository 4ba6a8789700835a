"""Dataset generation in PyTorch (counterpart of beats3d_tpu/data/datagen.py):
recorded (depth + colour) sessions -> labelled training data.

Per frame: deproject -> RANSAC plane (recomputed every 20 frames) ->
plane-band filter -> random in-plane augmentation about the cloud's
plane-space centroid -> re-render depth + colour (point-splat z-buffer +
hole fill, :mod:`..ops.render`) -> optional mask-forest background
rejection (kernel B1 on a card) -> colour-EM palette fit (first frame) ->
nearest-palette label ids -> PNGs + config.json in the reference dataset
format.

The per-frame work runs on ``device`` (the card unless the caller asks for
the CPU); the host draws the augmentation from the numpy ``Generator``, in
the JAX package's order, and encodes the PNGs.  Every step gives the card
the CPU's bits: the z-buffer and the palette statistics are integer
minima and sums, the centroid is summed in float64, and the transforms are
elementwise in a fixed order.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional

import numpy as np
import torch

from ..models.forest import DecisionForest
from ..ops import colors as colors_ops
from ..ops import plane as plane_ops, points, render
from ..ops.forest_eval_cuda import evaluate_forest_cuda

MAX_UINT16 = 65535


@dataclasses.dataclass
class DatagenConfig:
    num_colors: int = 4
    color_em_tries: int = 8
    color_em_iterations: int = 32
    plane_candidates: int = 25000
    plane_z_threshold: float = 40.0
    frames_per_recompute_plane: int = 20
    scale_variance: float = 0.1
    scale_skew_variance: float = 0.0
    rotate_variance: float = 0.0
    translate_variance: float = 0.0
    # Pre-rerender depth smoothing sigma (> 0.1 enables; 15x15 taps),
    # applied to the plane-filtered cloud's depth image, which is then
    # deprojected again and feeds the re-render.
    gaussian_noise: float = 0.0
    # Reject depth/colour pairs whose capture timestamps diverge by more
    # than this many MILLISECONDS.
    frames_timestamp_max_diff: float = 6.0
    max_images: Optional[int] = None
    mask_label: Optional[int] = None


def _aug_transform(plane_mat, center, scale, skew, rotate, translate):
    """The augmentation matrix: rotate about camera z, go to plane space,
    recentre, scale/skew/translate, restore, back to camera space (host
    float64, returned as float32)."""
    def T(v):
        m = np.eye(4, dtype=np.float64)
        m[:3, 3] = v
        return m

    def S(v):
        return np.diag(list(v) + [1.0])

    c, s = np.cos(rotate), np.sin(rotate)
    R = np.eye(4)
    R[0, 0], R[0, 1], R[1, 0], R[1, 1] = c, -s, s, c

    pm = np.asarray(plane_mat, np.float64)
    m = (
        np.linalg.inv(pm)
        @ T(center[:3])
        @ T(translate)
        @ S(scale + skew)
        @ T(-center[:3])
        @ pm
        @ R
    )
    return m.astype(np.float32)


def _prep_frame(depth, plane_mat, pp, focal, threshold):
    """Deproject, plane-filter, and return (plane-space points, their
    centroid (4,) float32 with w = 1 unless no point survived).

    The centroid's sum runs over every pixel in float64 and is rounded to
    float32 once, so it does not depend on the reduction order (the JAX
    package sums in float32, in XLA's order)."""
    pts = points.deproject_points(depth, pp, focal)
    q = points.transform_points(pts, plane_mat)
    qf = points.filter_points_by_plane(q, threshold)
    total = qf.reshape(-1, 4).to(torch.float64).sum(dim=0).to(torch.float32)
    center = total / torch.where(total[3] == 0, 1.0, total[3])
    return qf, center


def _rerender(pts_plane, colors, inv_plane, aug, pp, focal):
    """Back to camera space, augment, splat, hole-fill."""
    cam = points.transform_points(pts_plane, inv_plane)
    cam = points.transform_points(cam, aug)
    d, c = render.splat_points(cam, colors, pp, focal)
    return render.fill_holes(d, c)


def _rerender_smoothed(pts_plane, colors, inv_plane, aug, kernel, pp, focal):
    """Like :func:`_rerender`, but the camera-space cloud is re-sampled
    through a gaussian-smoothed depth image first (depths_from_points ->
    gaussian_depth_filter -> deproject)."""
    cam = points.transform_points(pts_plane, inv_plane)
    d = points.depths_from_points(cam).to(torch.int32)
    d = points.gaussian_depth_filter(d, kernel)
    cam = points.deproject_points(d, pp, focal)
    cam = points.transform_points(cam, aug)
    d, c = render.splat_points(cam, colors, pp, focal)
    return render.fill_holes(d, c)


def _label_frame(color, palette):
    """Snap colours to the palette and emit label ids 1..K, 0 for black.
    Returns ((H, W) uint16 labels, (H, W, 3) uint8 snapped colours)."""
    snapped = colors_ops.apply_point_mapping(color, palette)
    l = colors_ops.nearest_color_idx(snapped, palette) + 1
    is_black = snapped.to(torch.int32).sum(dim=-1) == 0
    return torch.where(is_black, 0, l).to(torch.uint16), snapped


def make_color_mapping(color_image, cfg: DatagenConfig, rng, device="cuda"):
    """EM palette fit: ``cfg.color_em_tries`` random restarts of k-means on
    ``device``, keep the lowest-cost palette (the first of equal costs).
    Returns (K, 3) uint8."""
    best_cost, best = np.inf, None
    img = torch.as_tensor(color_image, device=device)
    for _ in range(cfg.color_em_tries):
        init = rng.uniform(0, 255, (cfg.num_colors, 3)).astype(np.float32)
        pal, cost = colors_ops.kmeans_palette_step(
            img, torch.as_tensor(init, device=img.device),
            num_iters=cfg.color_em_iterations)
        cost = float(cost)
        if cost < best_cost:
            best_cost, best = cost, pal.cpu().numpy()
    return np.clip(best, 0, 255).astype(np.uint8)


class LiveDataConvert:
    """Streaming converter; feed (depth, colour) frames, writes the
    dataset.  ``mask_model``: a forest whose label ``cfg.mask_label`` marks
    the pixels to keep (the others lose their colour), evaluated by kernel
    B1 on a card and by its plain version on the CPU."""

    def __init__(self, out_path: str, intrinsics, cfg: DatagenConfig,
                 mask_model: Optional[DecisionForest] = None,
                 rng: Optional[np.random.Generator] = None, log=print,
                 device="cuda"):
        self.out = out_path
        os.makedirs(out_path, exist_ok=True)
        self.intrin = intrinsics
        self.cfg = cfg
        self.rng = rng or np.random.default_rng()
        self.log = log
        self.device = torch.device(device)
        self.mask_forest = (
            torch.as_tensor(np.ascontiguousarray(mask_model.data, np.float32),
                            device=self.device)
            if mask_model is not None else None
        )
        self.plane = plane_ops.CalibratedPlane(
            cfg.plane_candidates, cfg.plane_z_threshold, device=self.device)
        self.palette = None
        self.frame_count = 0
        self.frames_skipped = 0
        self._pp = intrinsics.pp
        self._f = np.float32(intrinsics.fx)
        self._gauss = (
            points.gaussian_kernel(15, cfg.gaussian_noise)
            if cfg.gaussian_noise > 0.1
            else None
        )

    def process_frame(self, depth: np.ndarray, color: np.ndarray,
                      depth_timestamp: Optional[float] = None,
                      color_timestamp: Optional[float] = None):
        """Convert one pair.  Returns False once ``max_images`` frames are
        written, else True (also for a pair the timestamp gate rejects)."""
        cfg = self.cfg
        if cfg.max_images and self.frame_count >= cfg.max_images:
            return False
        # only pairs whose timestamps (seconds) agree within the gate (ms)
        if depth_timestamp is not None and color_timestamp is not None:
            if (
                abs(depth_timestamp - color_timestamp) * 1e3
                > cfg.frames_timestamp_max_diff
            ):
                self.frames_skipped += 1
                return True
        dev = self.device
        depth_t = torch.as_tensor(np.asarray(depth).astype(np.int32),
                                  device=dev)

        if (
            not self.plane.is_set()
            or (self.frame_count + 1) % cfg.frames_per_recompute_plane == 0
        ):
            self.plane.make(points.deproject_points(depth_t, self._pp, self._f))

        mat = self.plane.get_mat()
        qf, center = _prep_frame(depth_t, mat, self._pp, self._f,
                                 cfg.plane_z_threshold)

        # no augmentation on the first three frames
        if self.frame_count > 2:
            scale = self.rng.normal(1.0, cfg.scale_variance)
            skew = self.rng.normal(0.0, cfg.scale_skew_variance, 3)
            rot = self.rng.normal(0.0, cfg.rotate_variance)
            trans = self.rng.normal(0.0, cfg.translate_variance, 3)
        else:
            scale, skew, rot, trans = 1.0, np.zeros(3), 0.0, np.zeros(3)
        mat_np = mat.cpu().numpy()
        aug = _aug_transform(mat_np, center.cpu().numpy(), scale, skew, rot,
                             trans)
        inv_plane = np.linalg.inv(mat_np.astype(np.float64)).astype(np.float32)

        color_t = torch.as_tensor(np.asarray(color, np.uint8), device=dev)
        if self._gauss is not None:
            d_new, c_new = _rerender_smoothed(
                qf, color_t, inv_plane, aug, self._gauss, self._pp, self._f)
        else:
            d_new, c_new = _rerender(qf, color_t, inv_plane, aug, self._pp,
                                     self._f)

        if self.mask_forest is not None:
            d_forest = points.convert_0s_to_maxuint(d_new.to(torch.int32))
            mask = evaluate_forest_cuda(d_forest[None].contiguous(),
                                        self.mask_forest)[0]
            keep = mask == cfg.mask_label
            c_new = torch.where(keep[..., None], c_new, 0).to(torch.uint8)

        if self.palette is None:
            self.log("making color mapping...")
            self.palette = make_color_mapping(c_new, cfg, self.rng, dev)
            self.log(f"palette:\n{self.palette}")

        labels, snapped = _label_frame(
            c_new, torch.as_tensor(self.palette, device=dev))

        self._save(d_new.cpu().numpy(), labels.cpu().numpy(),
                   snapped.cpu().numpy())
        self.frame_count += 1
        return True

    def _save(self, depth, labels, snapped):
        """Write the frame's depth, labels and their debug renders as PNGs
        (needs Pillow)."""
        from PIL import Image

        i = self.frame_count
        depth_out = depth.copy()
        depth_out[depth_out == 0] = MAX_UINT16
        Image.fromarray(depth_out).save(
            os.path.join(self.out, f"{i:08d}_depth.png")
        )
        Image.fromarray(labels).save(
            os.path.join(self.out, f"{i:08d}_labels.png")
        )
        rgba = np.zeros(labels.shape + (4,), np.uint8)
        rgba[..., 0:3] = snapped
        rgba[np.any(snapped > 0, axis=2), 3] = 255
        Image.fromarray(rgba).save(
            os.path.join(self.out, f"{i:08d}_labels_rgba.png")
        )
        # depth debug render
        drgba = np.zeros(labels.shape + (4,), np.uint8)
        drgba[depth_out == MAX_UINT16] = (167, 195, 162, 255)
        act = depth_out < MAX_UINT16
        if act.any():
            dmin, dmax = depth_out[act].min(), depth_out[act].max()
            norm = (255.0 * (1.0 - (depth_out[act] - float(dmin)) /
                             max(1.0, float(dmax - dmin)))).astype(np.uint8)
            drgba[act, 0] = norm
            drgba[act, 1] = norm
            drgba[act, 2] = norm
            drgba[act, 3] = 255
        Image.fromarray(drgba).save(
            os.path.join(self.out, f"{i:08d}_depth_rgba.png")
        )

    def finish(self):
        """Write config.json; returns its contents."""
        cfg = {
            "img_dims": [self.intrin.width, self.intrin.height],
            "num_images": self.frame_count,
            "id_to_color": {
                str(c + 1): [int(x) for x in self.palette[c]] + [255]
                for c in range(self.cfg.num_colors)
            },
        }
        with open(os.path.join(self.out, "config.json"), "w") as f:
            json.dump(cfg, f)
        return cfg
