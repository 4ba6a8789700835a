"""The per-frame inference pipeline (counterpart of
beats3d_tpu/runtime/pipeline.py).

One depth frame in, fingertip heights out:

    raw depth (H, W)
      -> plane-band filter + missing-aware 5x5 gaussian   (kernel K2)
      -> 1/8 mipmap shrink -> connected components +
         left/right hand selection on the device          (ops.components)
      -> grow + per-hand crop and stencil (the left hand
         mirrored, so the right-hand model applies)        (ops.points)
      -> layered decision forest, both hands in one launch (kernel K1)
      -> per-class mean-shift modes                         (ops.meanshift)
      -> fingertip heights above the plane from the RAW depth

The tap-detection state machine and MIDI stay on the host (runtime.app).

PyTorch runs this eagerly.  The JAX program's ``lax.cond``s become host
branches, each one device->host sync per frame: the crop-window check (and,
batched, the rescue count), plus one per union-find round in
``components``.  ``vmap`` becomes an explicit batch dimension.

Depth is carried as int32 inside (PyTorch's uint16 support is thin); the
outputs keep the JAX program's dtypes.  The backend follows the model's
device: ``"cuda"`` (kernels K1 and K2) for a CUDA model, ``"torch"`` (their
plain versions) for a CPU model.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..models.layered import LayeredDecisionForest, run_layered
from ..ops import components, forest_eval_cuda, meanshift, points, preproc_cuda

MAX_UINT16 = 65535


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Pipeline parameters.  Defaults mirror the reference app's tunables
    (3d_bz.py:49-65)."""

    height: int = 480
    width: int = 848
    labels_reduce: int = 2
    gauss_sigma: float = 2.0
    gauss_kernel_size: int = 5
    depth_mm_level: int = 3
    mean_shift_rounds: int = 6
    train_dim_x: int = 848
    fingertip_label_ids: Tuple[int, ...] = (2, 3, 4, 5, 6)
    # Per-hand crop window (full-res pixels) for forest eval.  The stencil
    # zeroes everything outside the hand, so evaluating a crop that holds
    # the whole grown group is exact.  Falls back to the full frame when a
    # hand's bbox exceeds the window.  Multiples of 16; the crop is off
    # when >= the frame dims.
    crop_h: int = 448
    crop_w: int = 512
    # Incoherence guard (kernel backend only): a hand image with more than
    # guard_tile_frac of its occupied 8x128 label tiles spread over more
    # than guard_spread depth units is zeroed before the eval (labels
    # 65535, means NaN, tips invalid; flagged in guard_muted) — the JAX
    # package's guard_mode="skip".  guard_spread <= 0 disables the guard.
    guard_spread: int = 1500
    guard_tile_frac: float = 0.25
    # Batched path: up to fallback_budget frames whose hand exceeds the
    # crop window are re-evaluated full-frame while the rest stay on the
    # crop path; with more, the whole batch runs full-frame.  0 disables
    # the per-frame rescue.
    fallback_budget: int = 2


def _fingertip_heights(raw_depth, means, plane_mat, pipe, cfg):
    """Fingertip heights above the plane, sampled from the RAW depth: mode
    pixel * labels_reduce -> raw depth -> deproject -> plane space ->
    height = -z.  Out-of-image or NaN modes are invalid.

    raw_depth (B, H, W) int32; means (B, 2, C, 2).  Returns heights
    (B, 2, F) float32, valid (B, 2, F) bool, tip_px (B, 2, F, 2) int32.
    """
    b, h, w = raw_depth.shape
    num_classes = means.shape[-2]
    dev = raw_depth.device
    sel = torch.tensor(cfg.fingertip_label_ids, dtype=torch.int64,
                       device=dev) - 1
    # a tip id beyond the model's class count comes out invalid
    in_range = sel < num_classes
    m = means[..., sel.clamp(0, num_classes - 1), :]      # (B, 2, F, 2)
    nanmask = torch.isnan(m).any(dim=-1)
    m_safe = torch.where(torch.isnan(m), -1.0, m)
    px = m_safe[..., 0].to(torch.int32) * cfg.labels_reduce
    py = m_safe[..., 1].to(torch.int32) * cfg.labels_reduce
    valid = in_range & ~nanmask & (px >= 0) & (py >= 0) & (px < w) & (py < h)
    pxc = px.clamp(0, w - 1)
    pyc = py.clamp(0, h - 1)
    lin = (pyc.to(torch.int64) * w + pxc).reshape(b, -1)
    z = torch.gather(raw_depth.reshape(b, h * w), 1, lin).reshape(
        pxc.shape).to(torch.float32)
    X = z * (pxc.to(torch.float32) - pipe.pp[0]) / pipe.fx
    Y = z * (pyc.to(torch.float32) - pipe.pp[1]) / pipe.fy
    # plane-space z = row 2 of the plane matrix applied to (X, Y, z, 1).
    # Coordinates reach 65535, so no TF32; the JAX program's dot runs on
    # the CPU as a chain of fused multiply-adds, emulated here in float64
    # (each product exact, one rounding to float32 per step), which
    # reproduces its heights on the CPU and the card alike.
    pz = None
    for a, m in ((X, plane_mat[2, 0]), (Y, plane_mat[2, 1]),
                 (z, plane_mat[2, 2]), (torch.ones_like(z), plane_mat[2, 3])):
        prod = a.to(torch.float64) * m.to(torch.float64)
        pz = (prod if pz is None else prod + pz.to(torch.float64)).to(
            torch.float32)
    return -pz, valid, torch.stack([px, py], dim=-1)


def _band_gauss(raw_depth, plane_mat, pipe, cfg):
    """(B, H, W) plane-band + gaussian, one launch of kernel K2 per batch."""
    return preproc_cuda.plane_band_gauss_cuda(
        raw_depth, plane_mat, pipe.intrin.pp, pipe.intrin.fx,
        pipe.plane_z_threshold, ksize=cfg.gauss_kernel_size,
        sigma=cfg.gauss_sigma,
    )


def _front_rest(depth1, group_min_size, cfg):
    """Shrink -> components -> grow, over a (B, H, W) batch."""
    small = points.shrink_image(depth1, cfg.depth_mm_level)
    groups_small, g_info = components.make_hand_groups(small, group_min_size)
    grown = points.grow_groups(groups_small)
    return grown, g_info, groups_small


def _full_stencils(depth1, grown, cfg):
    """Full-resolution per-hand stack (..., 2, H, W): right, mirrored left."""
    lvl = cfg.depth_mm_level
    d_right = points.stencil_depth_image_by_group(grown, depth1, lvl, 1)
    d_left = points.flip_x(
        points.stencil_depth_image_by_group(grown, depth1, lvl, 2))
    return points.convert_0s_to_maxuint(torch.stack([d_right, d_left], dim=-3))


def _stencil_crops(depth1, grown, oys, oxs, cfg, h, w):
    """Per-hand stencilled (2, crop_h, crop_w) crops cut straight from one
    frame's depth1 / grown at host-side origins; the left hand's
    (mirrored-space) origin maps to an unmirrored slice flipped after
    stencilling.  Bit-identical to cropping _full_stencils."""
    f = 1 << cfg.depth_mm_level
    ch, cw = cfg.crop_h, cfg.crop_w
    out = []
    for gid, oy, ox in ((1, oys[0], oxs[0]), (2, oys[1], w - cw - oxs[1])):
        d = depth1[oy:oy + ch, ox:ox + cw]
        g = grown[oy // f:(oy + ch) // f, ox // f:(ox + cw) // f]
        s = points.stencil_depth_image_by_group(g, d, cfg.depth_mm_level, gid)
        out.append(s if gid == 1 else points.flip_x(s))
    return points.convert_0s_to_maxuint(torch.stack(out))


def _spread_tiles(depth_imgs, r, cfg):
    """Per-(image, 8x128 label tile) (occupied, over-spread) masks: a tile is
    over-spread when its valid-depth range exceeds cfg.guard_spread."""
    n = depth_imgs.shape[0]
    c = depth_imgs[:, ::r, ::r].to(torch.int32)
    hl, wl = c.shape[1], c.shape[2]
    hp = ((hl + 7) // 8) * 8
    wp = ((wl + 127) // 128) * 128
    t = F.pad(c, (0, wp - wl, 0, hp - hl)).reshape(n, hp // 8, 8, wp // 128, 128)
    valid = (t > 0) & (t < MAX_UINT16)
    tmin = torch.where(valid, t, 1 << 20).amin(dim=(2, 4))
    tmax = torch.where(valid, t, -1).amax(dim=(2, 4))
    occupied = tmax >= 0
    spread = occupied & ((tmax - tmin) > cfg.guard_spread)
    return occupied, spread


def _incoherent_images(depth_imgs, r, cfg):
    """Per-image guard flags: (N,) bool, True for images whose own
    over-spread tile fraction exceeds cfg.guard_tile_frac."""
    occupied, spread = _spread_tiles(depth_imgs, r, cfg)
    n_occ = torch.clamp(occupied.sum(dim=(1, 2)), min=1).to(torch.float32)
    frac = spread.sum(dim=(1, 2)).to(torch.float32) / n_occ
    return frac > cfg.guard_tile_frac


def _crop_origins(grown, cfg, h, w):
    """Per-frame, per-hand crop origins around the grown group bbox (the left
    hand's mirrored) and the exceeds-crop flag, as host ints: one
    device->host copy for the whole batch.  Origins are multiples of the
    mipmap factor and of labels_reduce.

    grown (B, Hs, Ws).  Returns a list of ((oy_r, oy_l), (ox_r, ox_l),
    too_big) per frame.
    """
    ch, cw = cfg.crop_h, cfg.crop_w
    f = 1 << cfg.depth_mm_level
    if f % cfg.labels_reduce != 0:
        f *= cfg.labels_reduce
    masks = torch.stack([grown == 1, grown == 2], dim=1)   # (B, 2, Hs, Ws)
    occ = torch.cat([masks.any(dim=3), masks.any(dim=2)], dim=2).cpu().numpy()
    hs = grown.shape[1]

    def origin(lo, hi, crop, dim):
        c = min(max((lo + hi - crop) // 2, 0), dim - crop)
        return (c // f) * f

    out = []
    for frame in occ:
        oys, oxs, too_big = [], [], False
        for hand, mirrored in ((0, False), (1, True)):
            rows, cols = frame[hand, :hs], frame[hand, hs:]
            ylo = int(np.argmax(rows)) * f
            yhi = min((len(rows) - int(np.argmax(rows[::-1]))) * f, h)
            xlo = int(np.argmax(cols)) * f
            xhi = min((len(cols) - int(np.argmax(cols[::-1]))) * f, w)
            if mirrored:
                xlo, xhi = w - xhi, w - xlo
            oys.append(origin(ylo, yhi, ch, h))
            oxs.append(origin(xlo, xhi, cw, w))
            # f-1 slack: origin snapping can shift the window f-1 px left
            too_big |= bool(rows.any()) and (
                yhi - ylo > ch - f + 1 or xhi - xlo > cw - f + 1)
        out.append((tuple(oys), tuple(oxs), too_big))
    return out


def _eval_layers(depth_imgs, pipe, cfg, scale):
    """Layered eval of an (N, H, W) hand stack with the incoherence guard.
    Returns (labels (N, H//r, W//r) int32, guard_muted (N,) bool)."""
    r = cfg.labels_reduce
    noflags = torch.zeros(depth_imgs.shape[0], dtype=torch.bool,
                          device=depth_imgs.device)

    def fast(d):
        return run_layered(d, pipe.model, labels_reduce=r, scale_factor=scale)

    if pipe.backend != "cuda" or cfg.guard_spread <= 0:
        return fast(depth_imgs), noflags
    flags = _incoherent_images(depth_imgs, r, cfg)
    safe = torch.where(flags[:, None, None], 0, depth_imgs)
    return fast(safe), flags


def _place(canvas, crops, oys, oxs, r):
    """Slice-assign each (ch/r, cw/r) crop label image into its (Hl, Wl)
    canvas at the crop origin (in place)."""
    chl, cwl = crops.shape[-2:]
    for i in range(crops.shape[0]):
        y0, x0 = oys[i] // r, oxs[i] // r
        canvas[i, y0:y0 + chl, x0:x0 + cwl] = crops[i]
    return canvas


def _screen_means(m, oys, oxs, r, wl):
    """Crop-space modes (2, C, 2) -> screen coordinates: offset by the crop
    origin; the mirrored left hand maps through x -> wl - 1 - x."""
    sx = torch.stack([m[0, :, 0] + float(oxs[0] // r),
                      (wl - 1) - (m[1, :, 0] + float(oxs[1] // r))])
    sy = torch.stack([m[0, :, 1] + float(oys[0] // r),
                      m[1, :, 1] + float(oys[1] // r)])
    return torch.stack([sx, sy], dim=-1)


def _unmirror(lab):
    """(..., 2, Hl, Wl) per-hand labels -> screen frame (left hand flipped)."""
    return torch.stack([lab[..., 0, :, :], points.flip_x(lab[..., 1, :, :])],
                       dim=-3)


def _run_ms(labels, pipe):
    return meanshift.mean_shift(
        labels, pipe.variances, num_classes=pipe.num_classes,
        num_rounds=pipe.cfg.mean_shift_rounds)


def _use_crop(cfg, h, w):
    return (cfg.crop_h < h and cfg.crop_w < w and cfg.crop_h % 16 == 0
            and cfg.crop_w % 16 == 0)


def _scale(w, cfg):
    """Probe-offset scale: eval width over training width, in float32."""
    return float(np.float32(w) / np.float32(cfg.train_dim_x))


def frame_step(pipe: "FramePipeline", raw_depth, plane_mat):
    """One frame -> fingertips.  raw_depth (H, W) int32 and plane_mat
    (4, 4) float32 on the model's device.

    Returns a dict of tensors:
      labels (2, H//r, W//r) uint16 — per-hand composite labels, screen frame
      means (2, C, 2) float32       — per-hand per-class mean-shift modes
      heights (2, F) float32        — fingertip heights above the plane
      tip_valid (2, F) bool         — in-image and class-present mask
      tip_px (2, F, 2) int32        — fingertip pixel coords (full res)
      g_info (2, 3) float32         — (size, cx, cy) per hand group
      groups_small (Hs, Ws) uint16  — the mipmap-level group stencil
      guard_muted (2,) bool         — the incoherence guard zeroed this hand
    """
    cfg = pipe.cfg
    h, w = raw_depth.shape
    depth1 = _band_gauss(raw_depth[None], plane_mat, pipe, cfg)
    grown, g_info, groups_small = _front_rest(depth1, pipe.group_min_size, cfg)
    depth1, grown, g_info, groups_small = (
        depth1[0], grown[0], g_info[0], groups_small[0])

    scale = _scale(w, cfg)
    r = cfg.labels_reduce
    hl, wl = h // r, w // r

    def eval_full():
        lab, gf = _eval_layers(_full_stencils(depth1, grown, cfg), pipe, cfg,
                               scale)
        labels = _unmirror(lab)
        return labels, _run_ms(labels, pipe), gf

    use_crop = _use_crop(cfg, h, w)
    if use_crop:
        ((oys, oxs, too_big),) = _crop_origins(grown[None], cfg, h, w)
    if not use_crop or too_big:
        labels, ms, gmut = eval_full()
    else:
        crops = _stencil_crops(depth1, grown, oys, oxs, cfg, h, w)
        lc, gmut = _eval_layers(crops, pipe, cfg, scale)
        canvas = torch.full((2, hl, wl), MAX_UINT16, dtype=lc.dtype,
                            device=lc.device)
        labels = _unmirror(_place(canvas, lc, oys, oxs, r))
        # mean shift on the crops; a mirrored image yields the exactly
        # mirrored mode
        ms = _screen_means(_run_ms(lc, pipe), oys, oxs, r, wl)

    heights, tip_valid, tip_px = _fingertip_heights(
        raw_depth[None], ms[None], plane_mat, pipe, cfg)
    return {
        "labels": labels.to(torch.uint16),
        "means": ms,
        "heights": heights[0],
        "tip_valid": tip_valid[0],
        "tip_px": tip_px[0],
        "g_info": g_info,
        "groups_small": groups_small.to(torch.uint16),
        "guard_muted": gmut,
    }


def frame_step_batched(pipe: "FramePipeline", raw_depth, plane_mat):
    """Many frames -> fingertips: the throughput path.  raw_depth
    (B, H, W) int32 with one shared (4, 4) plane.

    All 2B hand crops run through one layered-eval launch, and mean shift
    runs on the crops.  Up to cfg.fallback_budget frames whose hand exceeds
    the crop window are rescued full-frame in a second launch; with more,
    the whole batch runs full-frame.  Returns frame_step's dict with a
    leading batch axis (minus groups_small).
    """
    cfg = pipe.cfg
    b, h, w = raw_depth.shape
    r = cfg.labels_reduce
    hl, wl = h // r, w // r
    ch, cw = cfg.crop_h, cfg.crop_w

    depth1 = _band_gauss(raw_depth, plane_mat, pipe, cfg)
    grown, g_info, _ = _front_rest(depth1, pipe.group_min_size, cfg)
    scale = _scale(w, cfg)

    def full_path(idx):
        hand_depth = _full_stencils(depth1[idx], grown[idx], cfg)
        lab, gf = _eval_layers(hand_depth.reshape(-1, h, w), pipe, cfg, scale)
        labels = _unmirror(lab.reshape(-1, 2, hl, wl))
        return labels, _run_ms(labels, pipe), gf.reshape(-1, 2)

    def crop_path(origins):
        # oversized-hand frames (rescued below) get zeroed crops
        crops = torch.stack([
            torch.zeros((2, ch, cw), dtype=torch.int32,
                        device=depth1.device) if too_big
            else _stencil_crops(depth1[i], grown[i], oys, oxs, cfg, h, w)
            for i, (oys, oxs, too_big) in enumerate(origins)
        ])
        lc, gf = _eval_layers(crops.reshape(2 * b, ch, cw), pipe, cfg, scale)
        lc = lc.reshape(b, 2, ch // r, cw // r)
        m = _run_ms(lc, pipe)
        canvas = torch.full((b, 2, hl, wl), MAX_UINT16, dtype=lc.dtype,
                            device=lc.device)
        means = []
        for i, (oys, oxs, _) in enumerate(origins):
            _place(canvas[i], lc[i], oys, oxs, r)
            means.append(_screen_means(m[i], oys, oxs, r, wl))
        return _unmirror(canvas), torch.stack(means), gf.reshape(b, 2)

    everything = list(range(b))
    if not _use_crop(cfg, h, w):
        labels, ms, gmut = full_path(everything)
    else:
        origins = _crop_origins(grown, cfg, h, w)
        bad = [i for i, o in enumerate(origins) if o[2]]
        if len(bad) > min(cfg.fallback_budget, b):
            labels, ms, gmut = full_path(everything)
        else:
            labels, ms, gmut = crop_path(origins)
            if bad:
                lab_r, ms_r, gf_r = full_path(bad)
                labels[bad] = lab_r
                ms[bad] = ms_r
                gmut[bad] = gf_r

    heights, tip_valid, tip_px = _fingertip_heights(
        raw_depth, ms, plane_mat, pipe, cfg)
    return {
        "labels": labels.to(torch.uint16),
        "means": ms,
        "heights": heights,
        "tip_valid": tip_valid,
        "tip_px": tip_px,
        "g_info": g_info,
        "guard_muted": gmut,
    }


class FramePipeline:
    """Binds a layered model + intrinsics + tunables to ``frame_step``.
    Runs on the model's device; holds no per-frame state."""

    def __init__(
        self,
        model: LayeredDecisionForest,
        intrinsics,
        cfg: Optional[PipelineConfig] = None,
        mean_shift_variances: Optional[np.ndarray] = None,
        plane_z_threshold: float = 40.0,   # 3d_bz.py:54
        group_min_size: float = 0.06,      # 3d_bz.py:63
    ):
        self.model = model
        self.intrin = intrinsics
        self.device = model.device
        self.cfg = cfg or PipelineConfig(
            height=intrinsics.height, width=intrinsics.width)
        self.backend = "cuda" if self.device.type == "cuda" else "torch"
        if self.backend == "cuda" and not forest_eval_cuda.kernel_supports(
                model.layers, model.conditions):
            raise ValueError(
                "the layered-eval kernel does not take this model (> 4 "
                "layers, > 16 trees or classes, or > 128 conditions)")
        if mean_shift_variances is None:
            # 3d_bz.py:108-110 — class 1 (hand) wide, fingertips tight.
            mean_shift_variances = np.array(
                [50.0] + [8.0] * (model.num_layered_classes - 1), np.float32)
        self.variances = torch.as_tensor(
            np.asarray(mean_shift_variances, np.float32), device=self.device)
        self.num_classes = model.num_layered_classes
        self.plane_z_threshold = plane_z_threshold
        self.group_min_size = group_min_size
        # intrinsics as float32 device tensors (divisors stay tensors: CUDA
        # divides by a Python scalar through its reciprocal)
        self.pp = torch.as_tensor(intrinsics.pp, device=self.device)
        self.fx = torch.tensor(intrinsics.fx, dtype=torch.float32,
                               device=self.device)
        self.fy = torch.tensor(intrinsics.fy, dtype=torch.float32,
                               device=self.device)

    def as_depth(self, raw):
        """A depth frame or batch (tensor or numpy) as int32 on the device."""
        raw = torch.as_tensor(raw)
        return raw.to(self.device).to(torch.int32).contiguous()

    def _plane(self, plane_mat):
        return torch.as_tensor(plane_mat).to(
            device=self.device, dtype=torch.float32).contiguous()

    def __call__(self, raw_depth, plane_mat):
        """(H, W) depth frame (tensor or numpy) -> see :func:`frame_step`."""
        return frame_step(self, self.as_depth(raw_depth), self._plane(plane_mat))

    def batch(self, raw_depths, plane_mat):
        """(B, H, W) frames with one shared plane -> see
        :func:`frame_step_batched`."""
        return frame_step_batched(
            self, self.as_depth(raw_depths), self._plane(plane_mat))

    def batch_sharded(self, raw_depths, plane_mat, mesh, axis: str = "data"):
        """The throughput path on a mesh of ranks: frames sharded over
        ``mesh``'s ``axis`` (counterpart of JAX's
        ``FramePipeline.batch_sharded``).

        Pure data parallelism: each rank runs :meth:`batch` (K2, grouping,
        K1, mean shift, heights) on its contiguous frame slice with the
        model replicated, with no collective inside the frame; the outputs
        are gathered over ``axis``.  ``raw_depths``: the whole (B, H, W)
        batch on every rank, B divisible by the axis size; the pipeline's
        model must lie on the mesh's device.  Returns :meth:`batch`'s dict
        for all B frames, on every rank.
        """
        if self.device != mesh.device:
            raise ValueError(f"batch_sharded: the model is on {self.device}, "
                             f"the mesh on {mesh.device}")
        out = self.batch(mesh.shard(torch.as_tensor(raw_depths), axis),
                         plane_mat)
        return {k: mesh.all_gather(v, axis) for k, v in out.items()}
