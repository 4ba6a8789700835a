"""The port's redesigned kernels on the card: K1 (layered forest), B4
(training split bits) and B1 (single forest), their inputs at the main
paths' shapes, the least time the card could take for them, and the
parent-against-change timing.

    python -m beats3d_tpu_torch.kernel_bench --parent DIR

DIR holds an earlier version of ``forest_eval.cu``, ``forest_walk.cuh`` and
``train_features.cu`` (for example ``git show REV:beats3d_tpu_torch/csrc/
FILE``), one whose B1 entry takes no ``lanes`` argument and whose K1 entry
does.  The script builds them with
the port's nvcc flags into ``build/``, checks that the earlier and the
current kernels give the plain versions' outputs, and times them in turns
(earlier, current, current, earlier) from CUDA graphs at every row.  Then
B1 for each lane grouping (``b1_variant``), the dense forest's repack into
K1's tables (``b1_repack``), and K1 for each lane grouping
(``k1_sweep``).  The B4 and B1 designs that measured slower (pixel lanes with the proposals split over warps, 4 or 8 pixels per
warp step, a reciprocal fast path for the divisions, lanes along the
walk, reading the next level ahead) are not kept; their times are in
PERF.md.  It prints one JSON line per measurement.  Needs a
CUDA card; imports nothing of JAX.

The inputs are the ones ``chip_smoke.py`` uses: the committed flagship, 16
articulated two-hand 848x480 scenes (seeds 1000-1015) and a RANSAC plane
from the first (``bench_inputs``); 4 single-hand training frames and 64
proposals (``b4_inputs``); the flagship's fine layer on the golden frames
(``b1_cases``).  The bounds follow the card's published peaks: 3.35 TB/s
of device memory and 67 TFLOP/s of float32 outside the tensor cores (the
larger of bytes / rate and operations / rate is the bound).
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

from .data.synth import articulated_scene, part_labels
from .models import LayeredDecisionForest
from .models.forest import PackedForest, forest_dims, kernel_tables
from .ops import (cuda_lib, forest_eval, forest_eval_cuda, points,
                  train_features, train_features_cuda)
from .ops import plane as plane_ops
from .runtime import pipeline as pl
from .train.proposals import make_random_features
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


def hand_frames(intrin, seeds):
    """(depth, labels) uint16 stacks of single-hand 848x480 training frames;
    the labels come from the rendered colours (part_labels)."""
    scenes = [articulated_scene(intrin, np.random.default_rng(s),
                                two_hands=False) for s in seeds]
    return (np.stack([d for d, _ in scenes]),
            np.stack([part_labels(c) for _, c in scenes]))


def division_edge(h=480, w=848, p=64, seed=7):
    """B4's division edge: every centre depth 1..65534 (a permutation, laid
    along the rows, so a probe one pixel off reads another depth), and
    proposals whose offsets are multiples of many depths (highly composite
    numbers, small integers, the image sides) or their float32 neighbours,
    thresholds across the features' range.  Returns (depth (1, h, w) int32,
    props (p, 5) float32) as numpy."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(65534).astype(np.int32) + 1
    depth = perm[np.arange(h * w) % 65534].reshape(1, h, w)
    base = np.array([1, 2, 3, 7, 12, 480, 848, 840, 5040, 27720, 55440,
                     65534, 65536, 360360, 720720], np.float32)
    u = rng.choice(base, size=(p, 4)) * rng.choice([-1.0, 1.0], size=(p, 4))
    u = u.astype(np.float32)
    step = rng.integers(-1, 2, size=(p, 4))
    u = np.where(step > 0, np.nextafter(u, np.float32(np.inf)),
                 np.where(step < 0, np.nextafter(u, np.float32(-np.inf)), u))
    thresh = rng.uniform(-30000.0, 30000.0, size=(p, 1))
    return depth, np.concatenate([u, thresh], axis=1).astype(np.float32)


def b4_cases(intrin, dev):
    """B4's inputs, name -> (depth, props, active): 4 single-hand training
    frames (seeds 2000-2003) with 64 proposals (seed 5) at the trainer's
    mask (its labelled pixels), at every pixel, and at a sparse mask (1 % of
    the pixels, scattered); and the division edge."""
    depth, labels = hand_frames(intrin, range(2000, 2004))
    d = torch.as_tensor(depth).to(dev).to(torch.int32).contiguous()
    props = torch.as_tensor(make_random_features(
        64, np.random.default_rng(5))).to(dev)
    sparse = np.random.default_rng(6).random(depth.shape) < 0.01
    edge_d, edge_p = division_edge()
    return {
        "active": (d, props, torch.as_tensor(labels > 0).to(dev)),
        "all": (d, props, None),
        "sparse": (d, props, torch.as_tensor(sparse).to(dev)),
        "edge": (torch.as_tensor(edge_d).to(dev), torch.as_tensor(edge_p).to(dev),
                 None),
    }


def b1_cases(model, dev):
    """B1's inputs on the flagship golden depth frames (2x480x848): name ->
    (dense forest, kwargs of evaluate_forest).  The fine layer (D=16, T=4,
    C=7) at r=1, at r=2 filtered on the coarse layer's class 1 (from the
    plain version), at scale 0.5; one tree with single-tree semantics (the
    trainer's candidate scoring) and two trees (its final forest)."""
    gold = np.load(os.path.join(FLAGSHIP, "golden_eval.npz"))
    depth = torch.as_tensor(gold["depth"]).to(dev).to(torch.int32).contiguous()
    fine = model.layers[1].flat
    coarse = forest_eval_cuda.evaluate_forest_plain(
        depth, model.layers[0].flat, labels_reduce=2)
    return depth, {
        "golden_r1": (fine, dict(labels_reduce=1)),
        "filter_r2": (fine, dict(labels_reduce=2, filter_images=coarse,
                                 filter_class=1)),
        "scale_0.5": (fine, dict(labels_reduce=2, scale_factor=0.5)),
        "one_tree": (fine[:1].contiguous(),
                     dict(labels_reduce=1, write_all_eligible=False)),
        "two_trees": (fine[:2].contiguous(), dict(labels_reduce=1)),
    }


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


# ------------------------------------------------ the earlier kernels

def build_parent(src_dir):
    """Build the earlier forest_eval.cu and train_features.cu of ``src_dir``
    (with its forest_walk.cuh) into build/beats3d_tpu_torch_parent/ with the
    port's flags; return the loaded library and nvcc's log."""
    srcs = [os.path.join(src_dir, f)
            for f in ("forest_eval.cu", "train_features.cu")]
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
        vp, vp, i, i, i, i, f, ctypes.POINTER(cuda_lib.LayerDesc), i, vp, i,
        i, vp]
    lib.b3d_evaluate_layered.restype = i
    lib.b3d_evaluate_forest.argtypes = [
        vp, vp, i, i, i, i, f, vp, i, i, i, vp, i, i, vp]
    lib.b3d_evaluate_forest.restype = i
    lib.b3d_train_feature_bits.argtypes = [vp, vp, i, vp, vp, i, i, i, vp]
    lib.b3d_train_feature_bits.restype = i
    return lib, proc.stdout + proc.stderr


def _stream():
    return torch.cuda.current_stream().cuda_stream


def _check(st, what):
    if st:
        raise RuntimeError(f"{what}: CUDA error {st}")


def parent_k1(lib, model, descs):
    def run(depth, r=2, scale=1.0):
        n, h, w = depth.shape
        out = torch.empty((n, h // r, w // r), dtype=torch.int32,
                          device=depth.device)
        _check(lib.b3d_evaluate_layered(
            depth.data_ptr(), out.data_ptr(), n, h, w, r, scale, descs,
            len(descs), model.conditions.data_ptr(), model.conditions.shape[0],
            0, _stream()), "earlier K1")
        return out
    return run


def forest_runner(lib, *, parent=False, lanes=0):
    """B1 from ``lib``: the earlier entry, or the current one with a lane
    grouping (0: the kernel's choice)."""
    def run(depth, flat, labels_reduce=1, filter_images=None, filter_class=-1,
            scale_factor=1.0, write_all_eligible=True):
        n, h, w = depth.shape
        r = labels_reduce
        t, lv, c = forest_dims(flat.shape)
        out = torch.empty((n, h // r, w // r), dtype=torch.int32,
                          device=depth.device)
        extra = () if parent else (lanes,)
        _check(lib.b3d_evaluate_forest(
            depth.data_ptr(), out.data_ptr(), n, h, w, r, float(scale_factor),
            flat.data_ptr(), t, lv, c,
            None if filter_images is None else filter_images.data_ptr(),
            int(filter_class), int(write_all_eligible), *extra, _stream()),
            "B1")
        return out
    return run


def bits_runner(lib):
    """B4 from ``lib``'s earlier entry, whose C signature it shares."""
    def run(depth, props, active):
        n, h, w = depth.shape
        p = props.shape[0]
        out = torch.empty((n, (p + 31) // 32, h, w), dtype=torch.int32,
                          device=depth.device)
        _check(lib.b3d_train_feature_bits(
            depth.data_ptr(), props.data_ptr(), p,
            None if active is None else active.data_ptr(), out.data_ptr(),
            n, h, w, _stream()), "B4")
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


def bench_b4(lib, intrin, dev, smi):
    old = bits_runner(lib)
    for name, (d, props, act) in b4_cases(intrin, dev).items():
        want = train_features.train_feature_bits_plain(d, props, act)
        new = train_features_cuda.train_feature_bits_cuda
        mism = (int((old(d, props, act) != want).sum()),
                int((new(d, props, act) != want).sum()))
        bms, by = bound(*b4_work(d, props, act))
        t = turns(lambda: old(d, props, act), lambda: new(d, props, act))
        say("b4_turns", card=smi, case=name, dims=list(d.shape),
            active_pixels=None if act is None else int(act.sum()),
            word_mismatches_old_new_vs_plain=mism, bound_ms=bms, bound_by=by,
            share_old=bms / t["old_mean_ms"], share_new=bms / t["new_mean_ms"],
            **t)


def bench_b1(lib, new_lib, model, dev, smi):
    old = forest_runner(lib, parent=True)
    new = forest_eval_cuda.evaluate_forest_cuda
    depth, cases = b1_cases(model, dev)
    for name, (flat, kw) in cases.items():
        want = forest_eval_cuda.evaluate_forest_plain(depth, flat, **kw)
        mism = (int((old(depth, flat, **kw) != want).sum()),
                int((new(depth, flat, **kw) != want).sum()))
        bms, by = bound(*forest_work(depth, flat, **kw))
        t = turns(lambda: old(depth, flat, **kw), lambda: new(depth, flat, **kw))
        say("b1_turns", card=smi, case=name, trees=int(flat.shape[0]),
            mismatches_old_new_vs_plain=mism, bound_ms=bms, bound_by=by,
            share_old=bms / t["old_mean_ms"], share_new=bms / t["new_mean_ms"],
            **t)
        rows = []
        for lanes in (1, 2, 4):
            run = forest_runner(new_lib, lanes=lanes)
            rows.append(dict(
                lanes=lanes,
                mismatches=int((run(depth, flat, **kw) != want).sum()),
                ms=graph_ms(lambda: run(depth, flat, **kw))))
        say("b1_variant", card=smi, case=name, rows=rows)
    one = cases["one_tree"][0]
    say("b1_repack", card=smi, case="one_tree",
        repacked="models.forest.kernel_tables of one D=16 tree",
        ms=graph_ms(lambda: kernel_tables(one)))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True,
                    help="directory with the earlier forest_eval.cu, "
                         "forest_walk.cuh and train_features.cu")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_bench: needs a CUDA device")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    say("device", card=smi)
    lib, log = build_parent(args.parent)
    new_lib = cuda_lib.library()
    say("build", parent_ptxas=cuda_lib.ptxas_summary(log),
        ptxas=cuda_lib.ptxas_summary(cuda_lib.LIBRARY.build.log))
    inp = bench_inputs(dev)
    m = inp.model
    bench_b4(lib, inp.intrin, dev, smi)
    bench_b1(lib, new_lib, m, dev, smi)
    K1 = forest_eval_cuda.evaluate_layered_cuda
    descs = forest_eval_cuda.layer_descs(m.layers, dev)
    old_k1 = parent_k1(lib, m, descs)
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
