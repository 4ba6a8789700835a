"""The per-frame inference pipeline (counterpart of
beats3d_tpu/runtime/pipeline.py).

One depth frame in, fingertip heights out:

    raw depth (H, W)
      -> plane-band filter + missing-aware 5x5 gaussian   (kernel K2)
      -> 1/8 mipmap shrink -> connected components ->
         left/right hand selection -> 1-pixel grow, one
         launch of the grouping kernel                     (ops.components)
      -> per-hand crop, stencil and incoherence guard (the
         left hand mirrored, so the right-hand model
         applies), one hand-image launch          (ops.hand_images_cuda)
      -> layered decision forest, both hands in one launch (kernel K1)
      -> labels placed on the screen, unmirrored  (ops.hand_images_cuda)
      -> per-class mean-shift modes, one launch of the
         mean-shift kernel                                 (ops.meanshift_cuda)
      -> fingertip heights above the plane from the RAW depth

The tap-detection state machine and MIDI stay on the host (runtime.app).

The frame programs (:func:`frame_step`, :func:`frame_step_batched`) read
nothing back to the host: crop origins, the crop-or-full choice, the
budgeted rescue and the grouping stage all stay on the device.  Each
``lax.cond`` of JAX's programs is a :func:`graph_cond.cond`: on CUDA,
FramePipeline captures each program once per input shape as a CUDA graph
(the counterpart of ``jax.jit``) whose conds are conditional nodes, so a
replay runs only the branch taken; eagerly both run and the result is
selected.  ``vmap`` becomes an explicit batch dimension.

Depth is carried as int32 inside (PyTorch's uint16 support is thin); the
outputs keep the JAX program's dtypes.  The backend follows the model's
device: ``"cuda"`` (kernels K1, K2, the grouping kernel, the hand-image and
label kernels and the mean-shift kernel) for a CUDA model, ``"torch"`` (their
plain versions) for a CPU model.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Optional, Tuple

import numpy as np
import torch

from ..models.layered import LayeredDecisionForest, run_layered
from ..ops import (components, forest_eval_cuda, hand_images_cuda,
                   meanshift_cuda, preproc_cuda)
from ..utils.profiler import TIMER, StageClock
from . import graph_cond
from .graph_cond import cond

# JAX's pipeline guards only where its TPU path runs the Pallas kernel, which
# takes a model of at most 128 condition rows (its
# LayeredDecisionForest.pallas_supported); a wider model runs the XLA
# evaluator there, unguarded.
GUARD_CONDITION_ROWS = 128

# The stage clock of the frame graph this thread is capturing (set by
# FrameGraph for the length of its capture).
_stamping = threading.local()


def stage(name: Optional[str]):
    """A stage boundary of a frame program: stage ``name`` starts here
    (None: the program ends here).  Under a :class:`FrameGraph` capture it
    captures a stamp (:class:`..utils.profiler.StageClock`), so that each
    replay sums its stages' device time on the card; eagerly it does
    nothing.  The stages partition a replay: ``front`` (K2, grouping, crop
    origins), ``eval`` (stencils or crops, K1, label placing and
    unmirroring, in each cond body), ``meanshift`` (mean shift, the
    screen-space modes, the rescue's merge) and ``heights``."""
    clock = getattr(_stamping, "clock", None)
    if clock is not None:
        clock.stamp(name)


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
    # Incoherence guard (kernel backend only, where JAX's TPU path guards:
    # see guards()): a hand image with more than guard_tile_frac of its
    # occupied 8x128 label tiles spread over more than guard_spread depth
    # units is zeroed before the eval (labels 65535, means NaN, tips
    # invalid; flagged in guard_muted) under guard_mode "skip".  Under
    # "xla" nothing is zeroed: JAX then chooses between two exact
    # evaluators, and K1 is exact and insensitive to the spread, so both
    # are its one launch.  guard_spread <= 0 disables the guard.
    guard_spread: int = 1500
    guard_tile_frac: float = 0.25
    guard_mode: str = "skip"
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
    sel = pipe.tip_rows
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
    """Shrink -> components -> grow, over a (B, H, W) batch: one launch of
    the grouping kernel on CUDA."""
    return components.hand_groups_grown(depth1, cfg.depth_mm_level,
                                        group_min_size)


def _crop_origins(grown, cfg, h, w):
    """Per-frame, per-hand crop origins around the grown group bbox (the left
    hand's mirrored) and the exceeds-crop flag, on the device (JAX's
    ``_crop_origins``).  Origins are multiples of the mipmap factor and of
    labels_reduce.

    grown (B, Hs, Ws).  Returns oys, oxs (B, 2) int32 and too_big (B,) bool.
    """
    ch, cw = cfg.crop_h, cfg.crop_w
    f = 1 << cfg.depth_mm_level
    if f % cfg.labels_reduce != 0:
        f *= cfg.labels_reduce
    hs, ws = grown.shape[-2:]
    masks = torch.stack([grown == 1, grown == 2], dim=1)   # (B, 2, Hs, Ws)
    rows = masks.any(dim=3).to(torch.int32)                # (B, 2, Hs)
    cols = masks.any(dim=2).to(torch.int32)                # (B, 2, Ws)
    # argmax of a 0/1 row is its first 1 (0 when there is none)
    ylo = rows.argmax(dim=-1) * f
    yhi = ((hs - rows.flip(-1).argmax(dim=-1)) * f).clamp(max=h)
    xlo = cols.argmax(dim=-1) * f
    xhi = ((ws - cols.flip(-1).argmax(dim=-1)) * f).clamp(max=w)
    # the left hand's stencil is mirrored, so is its bbox
    xlo, xhi = (torch.stack([xlo[:, 0], w - xhi[:, 1]], dim=1),
                torch.stack([xhi[:, 0], w - xlo[:, 1]], dim=1))

    def origin(lo, hi, crop, dim):
        c = ((lo + hi - crop) // 2).clamp(0, dim - crop)
        return ((c // f) * f).to(torch.int32)

    present = rows.any(dim=-1)
    # f-1 slack: origin snapping can shift the window f-1 px left
    too_big = (present & ((yhi - ylo > ch - f + 1)
                          | (xhi - xlo > cw - f + 1))).any(dim=1)
    return origin(ylo, yhi, ch, h), origin(xlo, xhi, cw, w), too_big


def guards(cfg: PipelineConfig, model: LayeredDecisionForest) -> bool:
    """Whether the kernel backend zeroes incoherent hand images, as JAX's
    TPU path does: the guard on, in mode "skip", on a model of at most
    GUARD_CONDITION_ROWS condition rows."""
    return (cfg.guard_spread > 0 and cfg.guard_mode == "skip"
            and model.conditions_np.shape[0] <= GUARD_CONDITION_ROWS)


def _hand_eval(pipe, depth1, grown, **kw):
    """The hand images of depth1 (B, H, W) / grown (B, Hs, Ws), cut at the
    crop origins or whole (``kw``: :func:`hand_images_cuda.hand_images`'
    window, origins, frames, mute, keep), with the incoherence guard where
    ``pipe.guarded``, then the layered eval.  Returns (labels (2B', ch//r,
    cw//r) int32, guard_muted (2B',) bool)."""
    cfg = pipe.cfg
    r = cfg.labels_reduce
    guard = ((r, cfg.guard_spread, cfg.guard_tile_frac) if pipe.guarded
             else None)
    imgs, flags = hand_images_cuda.hand_images(
        depth1, grown, cfg.depth_mm_level, guard=guard, **kw)
    return run_layered(imgs, pipe.model, labels_reduce=r,
                       scale_factor=_scale(depth1.shape[-1], cfg)), flags


def _screen_means(m, oys, oxs, r, wl):
    """Crop-space modes (B, 2, C, 2) -> screen coordinates: offset by the
    crop origin; the mirrored left hand maps through x -> wl - 1 - x."""
    sx = (oxs // r).to(torch.float32)[..., None] + m[..., 0]
    sy = (oys // r).to(torch.float32)[..., None] + m[..., 1]
    sx = torch.stack([sx[:, 0], (wl - 1) - sx[:, 1]], dim=1)
    return torch.stack([sx, sy], dim=-1)


def _run_ms(labels, pipe):
    return meanshift_cuda.mean_shift_cuda(
        labels, pipe.variances, num_classes=pipe.num_classes,
        num_rounds=pipe.cfg.mean_shift_rounds)


def _use_crop(cfg, h, w):
    return (cfg.crop_h < h and cfg.crop_w < w and cfg.crop_h % 16 == 0
            and cfg.crop_w % 16 == 0)


def _scale(w, cfg):
    """Probe-offset scale: eval width over training width, in float32."""
    return float(np.float32(w) / np.float32(cfg.train_dim_x))


def _front(pipe, raw_depth, plane_mat):
    """(B, H, W) raw depth -> K2, then shrink -> components -> grow."""
    depth1 = _band_gauss(raw_depth, plane_mat, pipe, pipe.cfg)
    grown, g_info, groups_small = _front_rest(depth1, pipe.gms, pipe.cfg)
    return depth1, grown, g_info, groups_small


def _full_path(pipe, depth1, grown, keep=None, frames=None):
    """Full-frame eval of (B, H, W) frames, or of the frames ``frames``
    (B',) picks: labels (B', 2, Hl, Wl), means (B', 2, C, 2), guard_muted
    (B', 2).  ``keep`` (B',) bool: the frames whose results will be used;
    the others' stencils are zeroed, so K1 skips their pixels (their
    results are garbage the caller drops)."""
    stage("eval")
    h, w = depth1.shape[1:]
    r = pipe.cfg.labels_reduce
    lab, gf = _hand_eval(pipe, depth1, grown, frames=frames, keep=keep)
    labels = hand_images_cuda.place_labels(
        lab.reshape(-1, 2, h // r, w // r), r)
    stage("meanshift")
    return labels, _run_ms(labels, pipe), gf.reshape(-1, 2)


def _crop_path(pipe, depth1, grown, oys, oxs, too_big=None):
    """Crop eval of (B, H, W) frames at device-side origins; frames whose
    ``too_big`` is set get zeroed crops (K1 skips them; the caller takes
    their results from the full path).  Mean shift runs on the crops; a
    mirrored image yields the exactly mirrored mode."""
    stage("eval")
    cfg = pipe.cfg
    b, h, w = depth1.shape
    r = cfg.labels_reduce
    ch, cw = cfg.crop_h, cfg.crop_w
    lc, gf = _hand_eval(pipe, depth1, grown, window=(ch, cw),
                        origins=(oys, oxs), mute=too_big)
    lc = lc.reshape(b, 2, ch // r, cw // r)
    labels = hand_images_cuda.place_labels(lc, r, origins=(oys, oxs),
                                           canvas=(h // r, w // r))
    stage("meanshift")
    means = _screen_means(_run_ms(lc, pipe), oys, oxs, r, w // r)
    return labels, means, gf.reshape(b, 2)


def _outputs(pipe, raw_depth, plane_mat, labels, means, gmut, g_info):
    heights, tip_valid, tip_px = _fingertip_heights(
        raw_depth, means, plane_mat, pipe, pipe.cfg)
    return {
        "labels": labels.to(torch.uint16),
        "means": means,
        "heights": heights,
        "tip_valid": tip_valid,
        "tip_px": tip_px,
        "g_info": g_info,
        "guard_muted": gmut,
    }


def frame_step(pipe: "FramePipeline", raw_depth, plane_mat):
    """One frame -> fingertips, the eager frame program.  raw_depth (H, W)
    int32 and plane_mat (4, 4) float32 on the model's device.  It reads
    nothing back to the host; on CUDA ``FramePipeline.__call__`` replays it
    from a CUDA graph.

    The crop-or-full choice is JAX's ``lax.cond`` on ``too_big``: the
    graph runs one branch, this eager program both, selecting the result.

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
    raw = raw_depth[None]
    stage("front")
    depth1, grown, g_info, groups_small = _front(pipe, raw, plane_mat)

    def full():
        return _full_path(pipe, depth1, grown)

    if not _use_crop(cfg, h, w):
        res = full()
    else:
        oys, oxs, too_big = _crop_origins(grown, cfg, h, w)

        def crop():
            return _crop_path(pipe, depth1, grown, oys, oxs)

        res = cond(too_big[0], full, crop)
    stage("heights")
    out = _outputs(pipe, raw, plane_mat, *res, g_info)
    out = {k: v[0] for k, v in out.items()}
    out["groups_small"] = groups_small[0].to(torch.uint16)
    stage(None)
    return out


def frame_step_batched(pipe: "FramePipeline", raw_depth, plane_mat):
    """Many frames -> fingertips, the eager batched program: the throughput
    path.  raw_depth (B, H, W) int32 with one shared (4, 4) plane.  Like
    :func:`frame_step` it reads nothing back; on CUDA ``FramePipeline.batch``
    replays it from one CUDA graph.

    JAX's ``frame_step_batched``, cond for cond: the front (K2, grouping,
    crop origins) runs once; then, with nbad frames whose hand exceeds the
    crop window and the budget fb = min(fallback_budget, B), either every
    frame on the crop path (all 2B hand crops in one layered-eval launch,
    mean shift on the crops) followed, when nbad > 0, by the oversized
    frames (up to fb) re-evaluated full-frame in a second launch; or, when
    nbad > fb, every frame full-frame.  Returns frame_step's dict with a
    leading batch axis (minus groups_small).
    """
    cfg = pipe.cfg
    b, h, w = raw_depth.shape
    stage("front")
    depth1, grown, g_info, _ = _front(pipe, raw_depth, plane_mat)

    def full():
        return _full_path(pipe, depth1, grown)

    if not _use_crop(cfg, h, w):
        res = full()
    else:
        oys, oxs, too_big = _crop_origins(grown, cfg, h, w)
        nbad = too_big.sum(dtype=torch.int32)
        fb = min(cfg.fallback_budget, b)

        def crop():
            return _crop_path(pipe, depth1, grown, oys, oxs, too_big)

        if fb == 0:
            res = cond(nbad > 0, full, crop)
        else:
            # the oversized frames first; padding rows (clean frames, when
            # nbad < fb) are zeroed for K1 and dropped by the upd mask
            ar = torch.arange(b, device=raw_depth.device)
            idx = torch.argsort(torch.where(too_big, ar, b + ar))[:fb]
            upd = too_big[idx]

            def rescue():
                return _full_path(pipe, depth1, grown, keep=upd, frames=idx)

            def none_oversized():
                # placeholders the all-false upd mask drops
                r = cfg.labels_reduce
                dev = raw_depth.device
                return (torch.zeros(fb, 2, h // r, w // r, dtype=torch.int32,
                                    device=dev),
                        torch.zeros(fb, 2, pipe.num_classes, 2, device=dev),
                        torch.zeros(fb, 2, dtype=torch.bool, device=dev))

            def crop_then_rescue():
                cropped = crop()
                rescued = cond(nbad > 0, rescue, none_oversized)
                return tuple(
                    c.index_copy(0, idx, torch.where(
                        upd.view((-1,) + (1,) * (c.dim() - 1)), r, c[idx]))
                    for r, c in zip(rescued, cropped))

            res = cond(nbad <= fb, crop_then_rescue, full)
    stage("heights")
    out = _outputs(pipe, raw_depth, plane_mat, *res, g_info)
    stage(None)
    return out


# The wrappers of the kernels the frame programs launch: a FrameGraph reads
# their launch counts around its capture to learn its launches per body.
FRAME_KERNELS = (forest_eval_cuda.evaluate_layered_cuda,
                 preproc_cuda.plane_band_gauss_cuda,
                 components.hand_groups_grown,
                 components.hand_groups_multiblock,
                 meanshift_cuda.mean_shift_cuda,
                 hand_images_cuda.hand_images,
                 hand_images_cuda.place_labels)


class FrameGraph:
    """One frame program captured as a CUDA graph for one input shape and
    replayed per call: the counterpart of ``jax.jit`` over the frame, its
    conds conditional nodes (:mod:`graph_cond`).

    ``depth`` and ``plane`` are the static inputs that :meth:`replay`
    writes (graphs of one shape share them); the pipeline's ``gms``
    scalar is read in place.  The program is warmed up once on a side
    stream, with synchronising calls made errors
    (``torch.cuda.set_sync_debug_mode``), then captured; a failed capture
    raises.  The kernel wrappers count the warm-up's launches (every body
    of every cond) and the capture's (each records its launch into the
    graph); a replay goes through no wrapper, so it moves no count.

    ``launches``: the wrappers' launches per replay of each body, by body
    (``""`` outside every cond) and wrapper name; ``replays``: the replays
    so far; :meth:`body_replays` reads each body's replays from the card.
    The capture holds the program's stage stamps (:func:`stage`), which
    add each replay's stage times to the registry of
    :func:`..utils.profiler.stage_ms` on the card.
    """

    def __init__(self, pipe, program, depth, plane):
        dev = depth.device
        self.depth, self.plane = depth, plane
        mode = torch.cuda.get_sync_debug_mode()
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        torch.cuda.set_sync_debug_mode("error")
        try:
            with torch.cuda.stream(side):
                program(pipe, depth, plane)
        finally:
            torch.cuda.set_sync_debug_mode(mode)
        torch.cuda.current_stream(dev).wait_stream(side)
        # the stamps write the clock's tensors at each replay: kept as long
        # as the graph
        self.clock = StageClock(program.__name__, dev)
        self.graph = torch.cuda.CUDAGraph()
        with graph_cond.graph(self.graph, FRAME_KERNELS,
                              capture_error_mode="thread_local") as capture:
            _stamping.clock = self.clock
            try:
                self.out = program(pipe, depth, plane)
            finally:
                _stamping.clock = None
        self.launches = capture.launches
        self.pool = capture.pool            # the graph's memory
        self._bodies = capture.bodies
        self._taken = capture.taken
        self.replays = 0

    def replay(self, depth=None, plane=None):
        """Write ``depth`` and ``plane``, when given, into the static inputs
        and run the graph on the current stream (span ``frame.replay``);
        returns its outputs cloned, so that they outlive the next replay
        (span ``frame.clone``)."""
        with TIMER.span("frame.replay"):
            if depth is not None:
                self.depth.copy_(depth)
                self.plane.copy_(plane)
            self.graph.replay()
        self.replays += 1
        with TIMER.span("frame.clone"):
            return {k: v.clone() for k, v in self.out.items()}

    def body_replays(self):
        """{body: replays so far} (a host read of the card's counters, for
        checks: the wrappers' launches the replays made are
        ``sum(body_replays()[b] * launches[b][name] for b in launches)``)."""
        taken = self._taken.tolist()
        out = {"": self.replays}
        out.update({b: taken[c][branch]
                    for b, (c, branch) in self._bodies.items()})
        return out


class FramePipeline:
    """Binds a layered model + intrinsics + tunables to the frame programs.
    Runs on the model's device: on CUDA each program is captured once per
    input shape as a :class:`FrameGraph` and replayed; on the CPU it runs
    eagerly.  Holds no per-frame state."""

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
        self.guarded = self.backend == "cuda" and guards(self.cfg, model)
        if self.backend == "cuda":
            graph_cond.require_support(self.device)
        if mean_shift_variances is None:
            # 3d_bz.py:108-110 — class 1 (hand) wide, fingertips tight.
            mean_shift_variances = np.array(
                [50.0] + [8.0] * (model.num_layered_classes - 1), np.float32)
        self.variances = torch.as_tensor(
            np.asarray(mean_shift_variances, np.float32), device=self.device)
        self.num_classes = model.num_layered_classes
        self.plane_z_threshold = plane_z_threshold
        # the mean-shift row of each fingertip label
        self.tip_rows = torch.tensor(self.cfg.fingertip_label_ids,
                                     dtype=torch.int64, device=self.device) - 1
        # group_min_size as a device scalar the frame programs read in place
        self.gms = torch.full((), float(group_min_size), dtype=torch.float32,
                              device=self.device)
        self._gms_value = float(group_min_size)
        # intrinsics as float32 device tensors (divisors stay tensors: CUDA
        # divides by a Python scalar through its reciprocal)
        self.pp = torch.as_tensor(intrinsics.pp, device=self.device)
        self.fx = torch.tensor(intrinsics.fx, dtype=torch.float32,
                               device=self.device)
        self.fy = torch.tensor(intrinsics.fy, dtype=torch.float32,
                               device=self.device)
        self.graphs = {}          # (program name, shape) -> FrameGraph
        self._inputs = {}         # shape -> the graphs' static (depth, plane)

    @property
    def group_min_size(self) -> float:
        return self._gms_value

    @group_min_size.setter
    def group_min_size(self, value: float):
        """Writes the tunable into ``gms`` in place (a fill on the device,
        ordered after the frames already queued), only when it changes."""
        value = float(value)
        if value != self._gms_value:
            self.gms.fill_(value)
            self._gms_value = value

    def as_depth(self, raw):
        """A depth frame or batch (tensor or numpy) as int32 on the device."""
        raw = torch.as_tensor(raw)
        return raw.to(self.device).to(torch.int32).contiguous()

    def _plane(self, plane_mat):
        return torch.as_tensor(plane_mat).to(
            device=self.device, dtype=torch.float32).contiguous()

    def _replay(self, program, depth, plane):
        """Replay program's graph for depth's shape on depth and plane,
        capturing it on first use."""
        shape = tuple(depth.shape)
        key = (program.__name__, shape)
        if key not in self.graphs:
            if shape not in self._inputs:
                self._inputs[shape] = (
                    torch.zeros(shape, dtype=torch.int32, device=self.device),
                    torch.eye(4, dtype=torch.float32, device=self.device))
            self.graphs[key] = FrameGraph(self, program, *self._inputs[shape])
        return self.graphs[key].replay(depth, plane)

    @property
    def replays(self) -> int:
        """Graph replays so far, over every program and shape."""
        return sum(g.replays for g in self.graphs.values())

    def __call__(self, raw_depth, plane_mat):
        """(H, W) depth frame (tensor or numpy) -> see :func:`frame_step`."""
        depth, plane = self.as_depth(raw_depth), self._plane(plane_mat)
        if self.device.type != "cuda":
            return frame_step(self, depth, plane)
        return self._replay(frame_step, depth, plane)

    def batch(self, raw_depths, plane_mat):
        """(B, H, W) frames with one shared plane -> see
        :func:`frame_step_batched` (span ``batch``)."""
        with TIMER.span("batch"):
            depth, plane = self.as_depth(raw_depths), self._plane(plane_mat)
            if self.device.type != "cuda":
                return frame_step_batched(self, depth, plane)
            return self._replay(frame_step_batched, depth, plane)

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
