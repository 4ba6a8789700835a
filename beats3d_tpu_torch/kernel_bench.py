"""The card inputs of the port's kernel rows and the work each kernel must
do on them, for ``chip_smoke.py``'s checks and kernels line and for the
card tests.

The inputs: the committed flagship, 16 articulated two-hand 848x480 scenes
(seeds 1000-1015), a RANSAC plane from the first and the pipeline's hand
crops of them (``bench_inputs``, ``hand_crops``, ``k1_shapes``); scenes
with a hand too big for the crop window (``oversized``); single-hand
training frames (``hand_frames``) and B4's cases with the division edge
(``b4_cases``, ``division_edge``); B1's cases and its pdf-sum mode's on the
golden frames (``b1_cases``, ``pdf_sum_cases``, ``pdf_sum_differ``); the
grouping stage's input and comparison (``grouping_depth``, ``serpentine``,
``grouping_compare``, ``exact_centroids``); mean shift's label images
(``ms_labels``); random dense forests and layered models past the
flagship's widths (``random_forest``, ``wide_layered``); and a plane
calibrated from the CPU's random stream on the card (``HostStreamPlane``).

The work counts (``k1_work``, ``k2_work``, ``forest_work``,
``pdf_sum_work``, ``b4_work``, ``grouping_work``, ``ms_work``) give the
bytes and operations a kernel cannot avoid, and ``bound`` the least time
the card could take for them at its published peaks: 3.35 TB/s of device
memory and 67 TFLOP/s of float32 outside the tensor cores (the larger of
bytes / rate and operations / rate).  Imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from .data.synth import articulated_scene, part_labels
from .models import FLAGSHIP, LayeredDecisionForest, load_flagship
from .models.forest import PackedForest, forest_dims
from .models.layered import run_layered
from .ops import (components, forest_eval, forest_eval_cuda,
                  hand_images_cuda, points)
from .ops import plane as plane_ops
from .runtime import pipeline as pl
from .train.proposals import make_random_features
from .utils import CameraIntrinsics

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
    """The pipeline's own per-hand 448x512 crops of each frame whose hands
    fit the crop window, cut at the device-side origins."""
    cfg = pipe.cfg
    h, w = frames.shape[1:]
    depth1, grown, _, _ = pl._front(pipe, frames, plane)
    oys, oxs, too_big = pl._crop_origins(grown, cfg, h, w)
    crops, _ = hand_images_cuda.hand_images(
        depth1, grown, cfg.depth_mm_level, window=(cfg.crop_h, cfg.crop_w),
        origins=(oys, oxs))
    crops = crops.reshape(-1, 2, cfg.crop_h, cfg.crop_w)[~too_big]
    return crops.reshape(-1, cfg.crop_h, cfg.crop_w).contiguous()


class HostStreamPlane(plane_ops.CalibratedPlane):
    """A CalibratedPlane whose candidates' uniforms are drawn on the CPU and
    copied to its device, so that a card run and a CPU run calibrate from
    the same stream (``chip_smoke.py``'s datagen card-against-CPU phase and
    the card tests)."""

    def __init__(self, num_random_guesses, threshold, device, seed=0):
        super().__init__(num_random_guesses, threshold, seed=seed,
                         device="cpu")
        self.device = torch.device(device)

    def make(self, pts, start_mat=None):
        u = torch.rand((self.num_random_guesses, 32), generator=self._gen,
                       dtype=torch.float32).to(self.device)
        self.plane = plane_ops.calibrate_plane(
            u, pts, float(self.plane_z_outlier_threshold), start_mat=start_mat)
        return self.plane


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


def oversized(scene, intrin):
    """A copy of an 848x480 bench scene with a 520x400 px blob 40 mm above
    the table across its left half: a hand too big for the 448x512 crop
    window, which the pipeline evaluates full-frame."""
    big = scene.copy()
    yy, xx = np.mgrid[0:intrin.height, 0:intrin.width].astype(np.float32)
    blob = (((xx - 0.45 * intrin.width) / 260.0) ** 2
            + ((yy - 0.5 * intrin.height) / 200.0) ** 2) < 1.0
    big[blob] = (big[blob].astype(np.int64) - 400).clip(1).astype(np.uint16)
    return big


def ms_labels(inp: BenchInputs):
    """Mean shift's main-path inputs, int32 label images at half resolution
    (K1 on the pipeline's own stencils): the live frame's 2 crops and the
    batched call's 32 (224x256), and the rescue's 4 full frames (240x424:
    scenes 1 and 4 made oversized, both hands)."""
    pipe, cfg = inp.pipe, inp.pipe.cfg
    h, w = inp.frames.shape[1:]
    r, scale = cfg.labels_reduce, pl._scale(w, cfg)
    crops = inp.crops
    if pipe.guarded:        # the guard as the pipeline applies it
        flags = hand_images_cuda.incoherent_images(
            crops, r, cfg.guard_spread, cfg.guard_tile_frac)
        crops = torch.where(flags[:, None, None], 0, crops)
    crops = run_layered(crops, pipe.model, labels_reduce=r,
                        scale_factor=scale)
    big = torch.stack([pipe.as_depth(oversized(inp.scenes[i], inp.intrin))
                       for i in (1, 4)])
    depth1, grown, _, _ = pl._front(pipe, big, inp.plane)
    lab, _ = pl._hand_eval(pipe, depth1, grown)
    full = hand_images_cuda.place_labels(lab.reshape(2, 2, h // r, w // r), r)
    return {"live": crops[:2].contiguous(), "batch": crops.contiguous(),
            "rescue": full.reshape(4, h // r, w // r).contiguous()}


def ms_work(labels, num_classes, num_rounds=6):
    """(bytes, operations) of one mean-shift call: the int32 labels read once
    and the (N, C, 2) modes written once; per labelled pixel (class 1..C) 3
    adds in round 0 and 12 float32 operations in each later round (2
    subtractions, 2 products and an add for the distance, a division, an
    exp, 2 products, 3 sums)."""
    n = labels.numel() // (labels.shape[-2] * labels.shape[-1])
    labelled = int(((labels >= 1) & (labels <= num_classes)).sum())
    bytes_moved = 4 * labels.numel() + 8 * n * num_classes
    return bytes_moved, labelled * (3 + 12 * (num_rounds - 1))


def serpentine(h=60, w=106):
    """(h, w) bool mask of one component snaking row by row: union-find's
    slowest shape for neighbour propagation."""
    m = np.zeros((h, w), bool)
    for r in range(0, h, 2):
        m[r, :] = True
        if r + 1 < h:
            m[r + 1, -1 if (r // 2) % 2 == 0 else 0] = True
    return m


def grouping_depth(inp: BenchInputs):
    """(16, 480, 848) int32: the bench scenes' K2 output, the grouping
    stage's input."""
    return pl._band_gauss(inp.frames, inp.plane, inp.pipe, inp.pipe.cfg)


def exact_centroids(small, groups):
    """The centroids (B, 2, 2) float32 (cx, cy) of the components that
    ``groups`` (B, h, w) marks right (1) and left (2) on the shrunk depth
    ``small`` (B, h, w), from their integer sums rounded to float32 once and
    an IEEE quotient: the grouping kernels' arithmetic, exact at any size.
    A side with no group takes the component rooted at pixel 0, or (0, 0)
    when pixel 0 is background.  Also returns the largest sum of x or y of
    those components (the plain version's float32 sums round past 2**24:
    ROADMAP C-w15).  On the CPU."""
    small = small.cpu()
    groups = groups.cpu()
    labels = components.label_components_plain(small > 0)
    b, h, w = small.shape
    out = torch.zeros((b, 2, 2), dtype=torch.float32)
    biggest = 0
    for i in range(b):
        for k in (0, 1):
            sel = groups[i] == k + 1
            if sel.any():
                root = labels[i][sel][0]
            elif small[i, 0, 0] > 0:
                root = labels[i, 0, 0]
            else:
                continue
            ys, xs = torch.nonzero(labels[i] == root, as_tuple=True)
            sums = torch.stack([xs.sum(), ys.sum()])
            biggest = max(biggest, int(sums.max()))
            out[i, k] = sums.to(torch.float32) / torch.tensor(
                float(xs.numel()), dtype=torch.float32)
    return out, biggest


def grouping_compare(got, want, small, groups=None):
    """The grouping kernel's outputs ``got`` against the plain version's
    ``want`` (tuples of the same order; g_info the float one), on the shrunk
    depth ``small``: every integer output and g_info's sizes must be equal;
    the centroids bit-equal to the plain version's while the sums stay
    below 2**24, and past that (C-w15) bit-equal to
    :func:`exact_centroids`, the plain version's distance from them
    reported.  ``groups``: the groups the centroids belong to (default the
    first int32 output).  Returns a dict of counts (``mismatches`` must be
    0)."""
    res = dict(mismatches=0, max_sum=None, plain_centroid_ulps=0)
    for a, b in zip(got, want):
        if not a.is_floating_point():
            res["mismatches"] += int((a != b).sum())
            continue
        a, b = a.reshape(-1, 2, 3).cpu(), b.reshape(-1, 2, 3).cpu()
        res["mismatches"] += int((a[..., 0].view(torch.int32)
                                  != b[..., 0].view(torch.int32)).sum())
        g = groups if groups is not None else next(
            t for t in got if t.dtype == torch.int32)
        exact, biggest = exact_centroids(small.reshape(-1, *small.shape[-2:]),
                                         g.reshape(-1, *g.shape[-2:]))
        res["max_sum"] = biggest
        ref = b[..., 1:] if biggest < 2 ** 24 else exact
        res["mismatches"] += int((a[..., 1:].view(torch.int32)
                                  != ref.view(torch.int32)).sum())
        res["plain_centroid_ulps"] = int(
            (b[..., 1:].view(torch.int32).long()
             - exact.view(torch.int32).long()).abs().max())
    return res


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


def pdf_sum_cases(model, dev):
    """B1's pdf-sum mode on the golden frames: name -> (dense forest,
    kwargs): the fine layer (T=4, D=16, C=7) at r=1, its two 2-tree shards
    (the tree-sharded eval's), and r=2 at scale 0.5."""
    depth, _ = b1_cases(model, dev)
    fine = model.layers[1].flat
    return depth, {
        "golden_r1": (fine, dict(labels_reduce=1)),
        "shard_0": (fine[:2].contiguous(), dict(labels_reduce=1)),
        "shard_1": (fine[2:].contiguous(), dict(labels_reduce=1)),
        "scale_0.5": (fine, dict(labels_reduce=2, scale_factor=0.5)),
    }


def pdf_sum_differ(got, want):
    """Where B1's pdf-sum outputs (pdf, eligible, all_done) differ from the
    plain version's: eligibility; sums (bits) and all_done on eligible
    pixels; sums or all_done off 0 and True on ineligible ones."""
    pdf, elig, done = (t.cpu().numpy() for t in got)
    w_pdf, w_elig, w_done = (t.cpu().numpy() for t in want)
    e = elig
    return dict(
        eligible=int((elig != w_elig).sum()),
        sums=int((pdf.view(np.uint32) != w_pdf.view(np.uint32))[e].sum()),
        all_done=int((done != w_done)[e].sum()),
        ineligible_nonzero=int(pdf[~e].any(-1).sum() + (~done[~e]).sum()))


def random_forest(rng, trees, levels, classes, leaf_prob=0.05,
                  off_mag=400.0):
    """A dense (trees, 2**levels - 1, 7 + 2 classes) float32 forest from
    ``rng`` (numpy): offsets within +-off_mag, thresholds within +-300, a
    side a leaf with probability ``leaf_prob`` (always on the last level),
    leaf pdfs uniform with class 0 at 0."""
    nodes = 2 ** levels - 1
    flat = np.zeros((trees, nodes, 7 + 2 * classes), np.float32)
    flat[..., :4] = rng.uniform(-off_mag, off_mag, (trees, nodes, 4))
    flat[..., 4] = rng.uniform(-300.0, 300.0, (trees, nodes))
    leaf = rng.random((trees, nodes, 2)) < leaf_prob
    leaf[:, 2 ** (levels - 1) - 1:] = True
    flat[..., 5:7] = np.where(leaf, 0.0, -1.0)
    pdf = rng.random((trees, nodes, 2, classes)).astype(np.float32)
    pdf[..., 0] = 0.0
    flat[..., 7:] = pdf.reshape(trees, nodes, 2 * classes)
    return flat


WIDE_FINAL_CLASSES = 7          # the composite's classes, as the flagship's


def wide_layered(rng, layers, trees, classes, cond_rows, levels):
    """A layered model past the flagship's widths, from ``rng``: ``layers``
    forests of ``trees`` trees, ``levels`` levels and ``classes`` classes,
    layer i > 0 filtered on layer i - 1's class 1, and a conditions table of
    ``cond_rows`` rows (>= 1 + (layers - 1) * classes) whose layers past
    the first sit at its end, so the composite reads its last rows: class 1
    of layer i < layers - 1 (weighted up in its leaves) moves on to layer
    i + 1, every other class
    emits one of 7 final classes.  Returns (layers as (flat, filter_model,
    filter_class), conditions (cond_rows, 2) int32, label colours (7, 4)
    uint8), the numpy parameters of models.layered.from_numpy."""
    offsets = [0] + [cond_rows - (layers - i) * classes
                     for i in range(1, layers)]
    if layers > 1 and offsets[1] < classes:
        raise ValueError(f"{cond_rows} condition rows do not hold {layers} "
                         f"layers of {classes} classes")
    cond = np.zeros((cond_rows, 2), np.int32)
    cond[:, 1] = 1 + np.arange(cond_rows) % WIDE_FINAL_CLASSES
    for i, o in enumerate(offsets):
        cond[o:o + classes, 1] = 1 + (i + np.arange(classes)) % WIDE_FINAL_CLASSES
        if i + 1 < layers:
            cond[o] = (1, offsets[i + 1])
    specs = []
    for i in range(layers):
        flat = random_forest(rng, trees, levels, classes)
        # class 1's leaf weights raised so that about half the pixels move
        # on to the next layer
        flat[..., 8::classes] *= 1.25 if i + 1 < layers else 1.0
        specs.append((flat, None if i == 0 else i - 1, None if i == 0 else 1))
    colors = np.stack([(37 * (c + 1)) % 256 * np.ones(4, np.uint8)
                       for c in range(WIDE_FINAL_CLASSES)]).astype(np.uint8)
    colors[:, 3] = 255
    return specs, cond, colors


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


def pdf_sum_work(depth, flat, *, labels_reduce=1, scale_factor=1.0):
    """(bytes, operations) of B1's pdf-sum mode: :func:`forest_work`'s node
    rows, leaf sides and operations, with the (N, Hl, Wl, C) float32 sums
    and the two (N, Hl, Wl) byte masks written in place of the labels."""
    c = forest_dims(flat.shape)[2]
    bytes_moved, ops = forest_work(depth, flat, labels_reduce=labels_reduce,
                                   scale_factor=scale_factor)
    n, h, w = depth.shape
    out = n * (h // labels_reduce) * (w // labels_reduce)
    return bytes_moved - 4 * out + (4 * c + 2) * out, ops


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


def grouping_work(b, h, w, mode):
    """(bytes, operations) of the grouping kernel on b images of h x w
    (the shrunk size) in ``mode``: "labels" reads the bool mask and writes
    int64 labels; "groups" reads the int32 depth at stride (one value a
    pixel) and the pct scalar and writes int32 groups and the 24-byte
    g_info; "stage" also writes int32 grown.  Operations per pixel: the
    mask and its left and up tests (3), then the sums (3) and the group
    tests (2), then the grow's four neighbour tests (4)."""
    n = b * h * w
    if mode == "labels":
        return 9 * n, 3 * n
    if mode == "groups":
        return 8 * n + 24 * b + 4, 8 * n
    return 12 * n + 24 * b + 4, 12 * n


def k2_work(depth):
    """(bytes, operations) of K2: each depth pixel read once and each output
    written once; per pixel the deprojection and plane test (12 operations,
    2 of them divisions), 4 per tap over 25 taps, the division and floor."""
    return 8 * depth.numel(), 114 * depth.numel()
