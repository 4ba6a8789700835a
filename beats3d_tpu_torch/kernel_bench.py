"""The live frame path's kernels, K1 (layered forest) and K2 (plane band +
gaussian), on the card: their inputs at the main path's shapes, the least
time the card could take for them, and the parent-against-change timing.

    python -m beats3d_tpu_torch.kernel_bench --parent DIR

DIR holds an earlier version of ``forest_eval.cu``, ``forest_walk.cuh`` and
``preproc.cu`` (for example ``git show REV:beats3d_tpu_torch/csrc/FILE``),
with the C entries and layer descriptor of that version.  The script builds
them with the port's nvcc flags into ``build/``, checks that the earlier and
the current kernels give the same outputs, times them in turns (earlier,
current, current, earlier) from CUDA graphs at every main-path shape, then
times K1 for every lane grouping.  It prints one JSON line
per measurement.  Needs a CUDA card; imports nothing of JAX.

The inputs (``bench_inputs``) are the ones ``chip_smoke.py`` uses: the
committed flagship, 16 articulated two-hand 848x480 scenes (seeds
1000-1015) and a RANSAC plane from the first.  The bounds follow the card's
published peaks: 3.35 TB/s of device memory and 67 TFLOP/s of float32
outside the tensor cores (the larger of bytes / rate and operations / rate
is the bound).
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import hashlib
import json
import os
import subprocess
import sys

import numpy as np
import torch

from .data.synth import articulated_scene
from .models import LayeredDecisionForest
from .models.forest import PackedForest, forest_dims
from .ops import cuda_lib, forest_eval, forest_eval_cuda, points, preproc_cuda
from .ops import plane as plane_ops
from .runtime import pipeline as pl
from .utils import CameraIntrinsics
from .utils.profiler import graph_ms

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP = os.path.join(ROOT, "models", "flagship")
MEM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3
F32_OPS_PER_S = 67e12            # H100 SXM float32, no tensor cores
BATCH = 16
THRESHOLD = 40.0


def bound(bytes_moved: float, ops: float):
    """(bound_ms, bound_by): the larger of the bytes' and the operations'
    time at the card's peaks."""
    t_bytes = bytes_moved / MEM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def load_flagship(device):
    """The committed trained flagship (coarse D=8 T=4 -> fine D=16 T=4)."""
    return LayeredDecisionForest.load(
        os.path.join(FLAGSHIP, "model_cfg.json"), labels_reduce=2,
        device=device)


@dataclasses.dataclass
class BenchInputs:
    intrin: CameraIntrinsics
    scenes: np.ndarray          # (16, 480, 848) uint16
    frames: torch.Tensor        # the same, int32 on the card
    plane: torch.Tensor         # (4, 4) float32 on the card
    model: LayeredDecisionForest
    pipe: pl.FramePipeline
    golden: torch.Tensor        # (2, 480, 848) int32: golden_eval.npz depth
    golden_labels: np.ndarray   # its labels at r = 2
    crops: torch.Tensor         # the pipeline's 448x512 hand crops, (32, ...)


def hand_crops(pipe, frames, plane):
    """The pipeline's own per-hand 448x512 crops of each frame."""
    cfg = pipe.cfg
    h, w = frames.shape[1:]
    depth1 = pl._band_gauss(frames, plane, pipe, cfg)
    grown, _, _ = pl._front_rest(depth1, pipe.group_min_size, cfg)
    origins = pl._crop_origins(grown, cfg, h, w)
    crops = [pl._stencil_crops(depth1[i], grown[i], oys, oxs, cfg, h, w)
             for i, (oys, oxs, too_big) in enumerate(origins) if not too_big]
    return torch.cat(crops).contiguous()


def bench_inputs(dev) -> BenchInputs:
    intrin = CameraIntrinsics.d415()
    scenes = np.stack([
        articulated_scene(intrin, np.random.default_rng(1000 + t),
                          two_hands=True, flex_scale=0.3)[0]
        for t in range(BATCH)
    ])
    frames = torch.as_tensor(scenes).to(dev).to(torch.int32)
    pts = points.deproject_points(frames[0], intrin.pp, intrin.fx)
    plane = plane_ops.CalibratedPlane(25000, THRESHOLD, seed=0,
                                      device=dev).make(pts).contiguous()
    model = load_flagship(dev)
    pipe = pl.FramePipeline(model, intrin)
    gold = np.load(os.path.join(FLAGSHIP, "golden_eval.npz"))
    golden = torch.as_tensor(gold["depth"]).to(dev).to(torch.int32).contiguous()
    return BenchInputs(intrin, scenes, frames, plane, model, pipe, golden,
                       gold["labels"][:, ::2, ::2],
                       hand_crops(pipe, frames, plane))


def k1_shapes(inp: BenchInputs):
    """K1's main-path inputs: the live frame's two crops, the batched
    call's 32, and the golden frames."""
    return {"live": inp.crops[:2].contiguous(), "batch": inp.crops,
            "golden": inp.golden}


def k1_work(model, depth, r=2, scale=1.0):
    """(bytes, operations) K1 must spend on ``depth``: the depth read once,
    the labels written once, the 32-byte header of every node row the
    pixels visit and the leaf pdf rows they reach (from the plain walk),
    the conditions; 9 float32 operations per pixel-tree-level step (4
    multiplies, 4 divisions, 1 subtraction) and C adds per leaf reached."""
    visits = forest_eval.layered_visits(
        depth, tuple(l.forest.tables() for l in model.layers),
        filter_specs=model.filter_specs(), labels_reduce=r,
        scale_factor=scale)
    n, h, w = depth.shape
    bytes_moved = 4 * depth.numel() + 4 * n * (h // r) * (w // r)
    bytes_moved += 4 * model.conditions.numel()
    ops = 0
    for v, l in zip(visits, model.layers):
        c = l.forest.num_classes
        bytes_moved += 32 * v["rows"] + 4 * c * v["leaves"]
        ops += 9 * v["steps"] + c * v["leaf_hits"]
    return bytes_moved, ops, visits


def forest_work(depth, flat, *, labels_reduce=1, filter_images=None,
                filter_class=-1, scale_factor=1.0, write_all_eligible=True):
    """(bytes, operations) of the single-forest kernel B1 on its dense
    layout: depth, labels and filter image once, the 7 header floats of
    every node row visited and the C pdf floats of every leaf side reached
    (from the plain walk); operations as in :func:`k1_work`."""
    _, _, c = forest_dims(flat.shape)
    visits = []
    forest_eval.forest_pdf_sum(
        depth, PackedForest.from_flat(flat).tables(),
        labels_reduce=labels_reduce, filter_images=filter_images,
        filter_class=filter_class, scale_factor=scale_factor, visits=visits)
    rows = torch.cat([r for r, _ in visits])
    leaves = torch.cat([l for _, l in visits])
    n, h, w = depth.shape
    out = n * (h // labels_reduce) * (w // labels_reduce)
    bytes_moved = 4 * depth.numel() + 4 * out * (2 if filter_images is not None else 1)
    bytes_moved += 28 * int(torch.unique(rows).numel())
    bytes_moved += 4 * c * int(torch.unique(leaves).numel())
    return bytes_moved, 9 * rows.numel() + c * leaves.numel()


def b4_work(depth, props, active):
    """(bytes, operations) of the split-bit kernel B4: depth, proposals and
    active mask read once, the packed words written once; 10 operations per
    (active pixel, proposal): the feature's 9 and the compare."""
    n, h, w = depth.shape
    p = props.shape[0]
    pixels = depth.numel() if active is None else int(active.sum())
    bytes_moved = 4 * depth.numel() + props.numel() * 4
    bytes_moved += 0 if active is None else active.numel()
    bytes_moved += 4 * n * ((p + 31) // 32) * h * w
    return bytes_moved, 10 * pixels * p


def k2_work(depth):
    """(bytes, operations) of K2: each depth pixel read once and each output
    written once; per pixel the deprojection and plane test (12 operations,
    2 of them divisions), 4 per tap over 25 taps, the division and floor."""
    return 8 * depth.numel(), 114 * depth.numel()


def k2_mix(inp, b=BATCH):
    """How K2's inputs mix kept and zero pixels on the bench frames: the
    share of band-kept pixels, and of 64x16 tiles and of 4x2 output blocks
    whose staged pixels (2-pixel halo) are all zero, all kept, or mixed."""
    import torch.nn.functional as F
    d1 = points.plane_band_depth(inp.frames[:b], inp.plane, inp.intrin.pp,
                                 inp.intrin.fx, THRESHOLD)
    v = F.pad(d1.to(torch.float32), (2, 2, 2, 2), value=-1.0)

    def shares(ty, tx):
        # (b, tiles_y, tiles_x, ty + 4, tx + 4) windows at stride (ty, tx)
        win = v.unfold(1, ty + 4, ty).unfold(2, tx + 4, tx).flatten(3)
        zero = (win == 0).all(-1)
        kept = (win > 0).all(-1)
        n = zero.numel()
        return dict(zero=int(zero.sum()) / n, kept=int(kept.sum()) / n,
                    mixed=int((~zero & ~kept).sum()) / n)

    return dict(kept_pixels=float((d1 > 0).float().mean()),
                tiles_64x16=shares(16, 64), blocks_4x2=shares(2, 4))


# ------------------------------------------------ the earlier kernels

class _OldLayerDesc(ctypes.Structure):
    _fields_ = [("forest", ctypes.c_void_p), ("trees", ctypes.c_int),
                ("levels", ctypes.c_int), ("classes", ctypes.c_int),
                ("filter_model", ctypes.c_int), ("filter_class", ctypes.c_int)]


def build_parent(src_dir):
    """Build the earlier forest_eval.cu and preproc.cu of ``src_dir`` into
    build/beats3d_tpu_torch_parent/ with the port's flags; return the
    loaded library and nvcc's log."""
    srcs = [os.path.join(src_dir, f) for f in ("forest_eval.cu", "preproc.cu")]
    h = hashlib.sha256(" ".join(cuda_lib.NVCC_FLAGS).encode())
    for f in srcs + [os.path.join(src_dir, "forest_walk.cuh")]:
        with open(f, "rb") as fh:
            h.update(fh.read())
    out_dir = os.path.join(ROOT, "build", "beats3d_tpu_torch_parent")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"libparent_{h.hexdigest()[:16]}.so")
    proc = subprocess.run(
        [cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-shared", "-o", path, *srcs],
        capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on the earlier kernels:\n{proc.stderr}")
    lib = ctypes.CDLL(path)
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.b3d_evaluate_layered.argtypes = [
        vp, vp, i, i, i, i, f, ctypes.POINTER(_OldLayerDesc), i, vp, i, vp]
    lib.b3d_evaluate_layered.restype = i
    lib.b3d_plane_band_gauss.argtypes = [
        vp, vp, i, i, i, vp, f, f, f, f, ctypes.POINTER(ctypes.c_float), vp]
    lib.b3d_plane_band_gauss.restype = i
    return lib, proc.stdout + proc.stderr


def parent_k1(lib, model):
    descs = (_OldLayerDesc * len(model.layers))()
    for i, l in enumerate(model.layers):
        descs[i] = _OldLayerDesc(
            l.flat.data_ptr(), l.forest.num_trees, l.forest.max_depth,
            l.forest.num_classes,
            -1 if l.filter_model is None else l.filter_model,
            0 if l.filter_model_class is None else l.filter_model_class)

    def run(depth, r=2, scale=1.0):
        n, h, w = depth.shape
        out = torch.empty((n, h // r, w // r), dtype=torch.int32,
                          device=depth.device)
        st = lib.b3d_evaluate_layered(
            depth.data_ptr(), out.data_ptr(), n, h, w, r, scale, descs,
            len(descs), model.conditions.data_ptr(), model.conditions.shape[0],
            torch.cuda.current_stream().cuda_stream)
        if st:
            raise RuntimeError(f"earlier K1: CUDA error {st}")
        return out
    return run


def parent_k2(lib, intrin):
    taps = points.gaussian_kernel(5, 2.0).reshape(-1)
    taps_c = (ctypes.c_float * 25)(*taps.tolist())

    def run(depth, plane):
        b, h, w = depth.shape
        out = torch.empty_like(depth)
        st = lib.b3d_plane_band_gauss(
            depth.data_ptr(), out.data_ptr(), b, h, w, plane.data_ptr(),
            float(np.float32(intrin.pp[0])), float(np.float32(intrin.pp[1])),
            float(np.float32(intrin.fx)), float(np.float32(THRESHOLD)), taps_c,
            torch.cuda.current_stream().cuda_stream)
        if st:
            raise RuntimeError(f"earlier K2: CUDA error {st}")
        return out
    return run


def turns(old, new, iters=20):
    """Times of old and new in the order old, new, new, old."""
    t = [graph_ms(old, iters), graph_ms(new, iters), graph_ms(new, iters),
         graph_ms(old, iters)]
    return dict(old_ms=[t[0], t[3]], new_ms=[t[1], t[2]],
                old_mean_ms=(t[0] + t[3]) / 2, new_mean_ms=(t[1] + t[2]) / 2)


def say(what, **kw):
    print(json.dumps({"bench": what, **kw}), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True,
                    help="directory with the earlier forest_eval.cu, "
                         "forest_walk.cuh and preproc.cu")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_bench: needs a CUDA device")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    say("device", card=smi)
    lib, log = build_parent(args.parent)
    cuda_lib.library()
    say("build", parent_ptxas=cuda_lib.ptxas_summary(log),
        ptxas=cuda_lib.ptxas_summary(cuda_lib.LIBRARY.build.log))
    inp = bench_inputs(dev)
    m = inp.model
    K1 = forest_eval_cuda.evaluate_layered_cuda
    K2 = preproc_cuda.plane_band_gauss_cuda
    old_k1, old_k2 = parent_k1(lib, m), parent_k2(lib, inp.intrin)
    descs = forest_eval_cuda.layer_descs(m.layers, dev)

    for name, depth in k1_shapes(inp).items():
        want = forest_eval_cuda.evaluate_layered_plain(
            depth, m.layers, m.conditions, labels_reduce=2)
        a, b = old_k1(depth), K1(depth, m.layers, m.conditions,
                                 labels_reduce=2, descs=descs)
        mism = (int((a != want).sum()), int((b != want).sum()))
        bytes_moved, ops, _ = k1_work(m, depth)
        bms, by = bound(bytes_moved, ops)
        t = turns(lambda: old_k1(depth),
                  lambda: K1(depth, m.layers, m.conditions, labels_reduce=2,
                             descs=descs))
        say("k1_turns", card=smi, shape=name, dims=list(depth.shape),
            mismatches_old_new_vs_plain=mism, bound_ms=bms, bound_by=by,
            share_old=bms / t["old_mean_ms"], share_new=bms / t["new_mean_ms"],
            **t)
    for b in (1, BATCH):
        raw = inp.frames[:b].contiguous()
        args_k2 = (inp.plane, inp.intrin.pp, inp.intrin.fx, THRESHOLD)
        want = preproc_cuda.plane_band_gauss_plain(raw, *args_k2)
        a, c = old_k2(raw, inp.plane), K2(raw, *args_k2)
        errs = (int((a - want).abs().max()), int((c - want).abs().max()))
        bms, by = bound(*k2_work(raw))
        t = turns(lambda: old_k2(raw, inp.plane), lambda: K2(raw, *args_k2))
        say("k2_turns", card=smi, batch=b, dims=list(raw.shape),
            mix=k2_mix(inp, b),
            max_abs_err_old_new=errs, bound_ms=bms, bound_by=by,
            share_old=bms / t["old_mean_ms"], share_new=bms / t["new_mean_ms"],
            **t)
    for name, depth in k1_shapes(inp).items():
        ref = K1(depth, m.layers, m.conditions, labels_reduce=2, descs=descs)
        rows = []
        for lanes in (1, 2, 4, 8):
            kw = dict(labels_reduce=2, descs=descs, lanes=lanes)
            got = K1(depth, m.layers, m.conditions, **kw)
            rows.append(dict(
                lanes=lanes, mismatches=int((got != ref).sum()),
                ms=graph_ms(lambda: K1(depth, m.layers, m.conditions, **kw))))
        say("k1_sweep", card=smi, shape=name, rows=rows)


if __name__ == "__main__":
    sys.exit(main())
