"""Build Keskin et al.'s local expert network (Hand Pose Estimation and Hand
Shape Classification Using Multi-layered Randomized Decision Forests,
ECCV 2012) on the flagship's recipe: a router forest sends each hand pixel
to one of 8 expert part forests, one per hand shape.

    layer 0     the flagship's coarse hand layer (models/flagship/m0.npy)
    layer 1     the router, D=16 T=4, 9 classes (0: no expert), on layer
                0's class 1
    layers 2-9  expert k = 1..8, D=16 T=4, the fine layer's 7 classes, on
                layer 1's class k

Steps:

1. frames: one-hand 848x480 frames at ``flex_scale`` 1.0 from the recipe's
   training stream (``flagship_v2.TRAIN_SEED``), each with its shape class
   (``data.synth.shape_class``: 3 bits of the drawn finger flexes, a fixed
   partition of the generator's pose parameters where Keskin et al.
   cluster real poses); the first 60 frames of each class train, the next
   8 are held out, drawn in order until every class is full, and only
   those go through the recipe's converter;
2. the router on the training frames' hand pixels, each labelled with its
   frame's class + 1;
3. each expert on its class's frames with the fine recipe (128 proposals in
   blocks of 64, 4 images a block);
4. assembly: ``model_cfg.json`` (condition rows that name the expert
   layer), ``m0.npy``, ``router.npy.gz``, ``expert1..8.npy.gz``;
5. held-out part accuracy against the flagship's fine layer on the same
   frames, the router's accuracy, K1 against its plain version, and
   ``RESULTS.json``.

Run on the card:

    python -m beats3d_tpu_torch.scripts.keskin_len [TRAIN_PER_CLASS TEST_PER_CLASS]

Writes the model to ``B3D_KESKIN_OUT`` (default ``build/keskin_len``; the
committed ``models/keskin_len`` is never the default) and the converter's
config to ``B3D_KESKIN_OUT``/ds.  Frames stay in memory (no PNG).
"""

from __future__ import annotations

import gzip
import json
import os
import shutil
import sys
import time

import numpy as np
import torch

from ..data.dataset import ArrayDataset
from ..data.synth import articulated_scene, shape_class
from ..models import FLAGSHIP, load_flagship
from ..models.layered import LayeredDecisionForest
from ..train import train_forest
from ..utils import CameraIntrinsics
from . import flagship_v2, resolve_device

OUT = os.environ.get("B3D_KESKIN_OUT", os.path.join("build", "keskin_len"))
EXPERTS = 8
PART_CLASSES = 7                 # background + the 6 palette colours
TRAIN_PER_CLASS, TEST_PER_CLASS = 60, 8
FLEX_SCALE = 1.0
ROUTER_SEED, EXPERT_SEED = 17, 19        # expert k trains from EXPERT_SEED + k
MAX_DRAWS = 20000
MAX_UINT16 = 65535


def step_frames(intrin, n_train, n_test, *, device, log=print):
    """Step 1.  Returns (frames: [(depth, part labels, class)] in drawing
    order, train then held-out per class as the split puts them; the
    split's {"train", "test"} frame indices; the converter's dataset
    config; frames drawn)."""
    t0 = time.time()
    want = n_train + n_test
    ds = os.path.join(OUT, "ds")
    if os.path.exists(ds):
        shutil.rmtree(ds)
    conv = flagship_v2.recipe_converter(ds, intrin, EXPERTS * want,
                                        device=device, log=log)
    frames = []
    conv._save = lambda d, l, s: frames.append(
        (np.where(d == 0, MAX_UINT16, d).astype(np.uint16), l))
    rng = np.random.default_rng(flagship_v2.TRAIN_SEED)
    taken = [0] * EXPERTS
    classes, split = [], {"train": [], "test": []}
    draws = 0
    while min(taken) < want:
        if draws == MAX_DRAWS:
            raise RuntimeError(f"{draws} frames drew classes {taken}")
        flex = []
        depth, color = articulated_scene(intrin, rng, two_hands=False,
                                         flex_scale=FLEX_SCALE, flexes=flex)
        draws += 1
        k = shape_class(flex[0])
        if taken[k] == want:
            continue
        t = len(frames)
        conv.process_frame(depth, color, depth_timestamp=t / 90.0,
                           color_timestamp=t / 90.0 + 0.002)
        split["train" if taken[k] < n_train else "test"].append(t)
        classes.append(k)
        taken[k] += 1
        if len(frames) % 100 == 0:
            log(f"[frames] {len(frames)} converted of {draws} drawn "
                f"({time.time() - t0:.0f}s)")
    ds_cfg = conv.finish()
    log(f"[frames] {len(frames)} frames ({draws} drawn) in "
        f"{time.time() - t0:.1f}s")
    return ([(d, l, k) for (d, l), k in zip(frames, classes)], split, ds_cfg,
            draws)


def _stack(frames, idx, labels):
    """(depth, labels) of the frames ``idx``; ``labels(f)`` gives a
    frame's label image."""
    return (np.stack([frames[i][0] for i in idx]),
            np.stack([labels(frames[i]) for i in idx]))


def route_labels(frame):
    """The router's labels of a frame: its hand pixels (part label above 0)
    take the frame's class + 1, the rest 0."""
    _, parts, k = frame
    return np.where(parts > 0, k + 1, 0).astype(np.uint16)


def _train(train, test, classes, seed, *, device, log):
    return train_forest(
        ArrayDataset(*train, classes,
                     images_per_block=flagship_v2.IMAGES_PER_BLOCK),
        ArrayDataset(*test, classes),
        num_random_features=flagship_v2.PROPOSALS,
        proposals_per_block=flagship_v2.PROPOSALS_BLOCK,
        images_per_block=flagship_v2.IMAGES_PER_BLOCK,
        max_tree_depth=flagship_v2.FINE_DEPTH,
        trees_in_forest=flagship_v2.TREES, trees_to_try=flagship_v2.TREES,
        rng=np.random.default_rng(seed), device=device, log=log)


def step_router(frames, split, *, device, log=print):
    """Step 2.  Returns (forest, seconds)."""
    t0 = time.time()
    router = _train(_stack(frames, split["train"], route_labels),
                    _stack(frames, split["test"], route_labels),
                    EXPERTS + 1, ROUTER_SEED, device=device, log=log)
    t = time.time() - t0
    log(f"[router] pct_match={router.pct_match:.4f} in {t:.1f}s")
    return router, t


def step_experts(frames, split, *, device, log=print):
    """Step 3.  Returns ([forest per class], seconds)."""
    t0 = time.time()
    experts = []
    for k in range(EXPERTS):
        mine = {s: [i for i in split[s] if frames[i][2] == k]
                for s in ("train", "test")}
        e = _train(_stack(frames, mine["train"], lambda f: f[1]),
                   _stack(frames, mine["test"], lambda f: f[1]),
                   PART_CLASSES, EXPERT_SEED + 1 + k, device=device, log=log)
        log(f"[expert {k + 1}] pct_match={e.pct_match:.4f} "
            f"({time.time() - t0:.0f}s)")
        experts.append(e)
    return experts, time.time() - t0


def model_config(colors):
    """The layered model's config: coarse class 1 -> the router (offset 1);
    router class k -> expert k at layer 1 + k (offset 9); expert class c
    -> final class c."""
    return {
        "layers": (
            [{"model": "m0.npy"},
             {"model": "router.npy.gz", "filter_model": 0,
              "filter_model_class": 1}]
            + [{"model": f"expert{k}.npy.gz", "filter_model": 1,
                "filter_model_class": k} for k in range(1, EXPERTS + 1)]),
        "conditions": (
            [[1, 1]] + [[1, 1 + EXPERTS, 1 + k]
                        for k in range(1, EXPERTS + 1)]
            + [[0, c] for c in range(1, PART_CLASSES)]),
        "label_colors": colors,
    }


def _save_gz(path, data):
    with gzip.open(path, "wb") as f:
        np.save(f, data)


def step_assemble(router, experts, ds_cfg, *, device):
    """Step 4: the model under ``OUT``; returns it loaded on ``device``
    (labels at half resolution)."""
    os.makedirs(OUT, exist_ok=True)
    shutil.copyfile(os.path.join(FLAGSHIP, "m0.npy"),
                    os.path.join(OUT, "m0.npy"))
    _save_gz(os.path.join(OUT, "router.npy.gz"), router.data)
    for k, e in enumerate(experts, start=1):
        _save_gz(os.path.join(OUT, f"expert{k}.npy.gz"), e.data)
    colors = [[int(v) for v in ds_cfg["id_to_color"][str(i + 1)]]
              for i in range(PART_CLASSES - 1)]
    with open(os.path.join(OUT, "model_cfg.json"), "w") as f:
        json.dump(model_config(colors), f, indent=1)
    return load_flagship(device, OUT)


def _accuracy(model, depth, truth, plain=False):
    lab = flagship_v2.eval_chunked(model, depth, plain=plain)
    on = truth > 0
    return lab, float((lab[on] == truth[on]).mean())


def step_heldout(model, frames, split, *, device, log=print):
    """Step 5's evaluation on the held-out frames: part accuracy of this
    model and of the flagship, K1 against its plain version, the router's
    accuracy on hand pixels and each expert's share of the routed
    pixels.  Returns a dict."""
    depth, parts = _stack(frames, split["test"], lambda f: f[1])
    _, routes = _stack(frames, split["test"], route_labels)
    before = model.counts.acc.clone()
    lab, acc = _accuracy(model, depth, parts)
    walked = (model.counts.acc - before)[:, 0].cpu().tolist()
    lab_plain = flagship_v2.eval_chunked(model, depth, plain=True)
    mism = int((lab != lab_plain).sum())
    _, acc_flagship = _accuracy(load_flagship(device), depth, parts)
    # the router alone, as a chain that emits its class
    chain = LayeredDecisionForest.from_numpy(
        [(l.flat.cpu().numpy(), l.filter_model, l.filter_model_class)
         for l in model.layers[:2]],
        [[1, 1]] + [[0, k] for k in range(1, EXPERTS + 1)],
        np.zeros((EXPERTS, 4), np.uint8), device, labels_reduce=1)
    _, acc_router = _accuracy(chain, depth, routes)
    shares = [w / max(1, sum(walked[2:])) for w in walked[2:]]
    log(f"[held-out] parts {acc:.4f} (flagship {acc_flagship:.4f}), router "
        f"{acc_router:.4f}, K1 vs plain {mism} mismatches, expert shares "
        f"{[round(s, 3) for s in shares]}")
    return {"part_pct_match": round(acc, 4),
            "flagship_part_pct_match": round(acc_flagship, 4),
            "router_pct_match": round(acc_router, 4),
            "k1_plain_mismatches": mism,
            "expert_pixel_shares": [round(s, 4) for s in shares]}


def step_write(split, frames, ds_cfg, draws, router, t_router, experts,
               t_experts, heldout, seconds):
    """Step 5's ``RESULTS.json``; returns it."""
    per_class = {s: np.bincount([frames[i][2] for i in split[s]],
                                minlength=EXPERTS).tolist()
                 for s in ("train", "test")}
    with open(os.path.join(FLAGSHIP, "model_cfg.json")) as f:
        flagship_colors = json.load(f)["label_colors"]
    with open(os.path.join(OUT, "model_cfg.json")) as f:
        colors = json.load(f)["label_colors"]
    summary = {
        "architecture": "Keskin et al., ECCV 2012, local expert network: "
                        "coarse hand layer, router of 8 shape classes, 8 "
                        "expert part forests",
        "seeds": {"scenes": flagship_v2.TRAIN_SEED,
                  "converter": flagship_v2.CONVERTER_SEED,
                  "router": ROUTER_SEED,
                  "experts": [EXPERT_SEED + 1 + k for k in range(EXPERTS)]},
        "shape_class": "3 bits of the drawn finger flexes (data.synth."
                       "shape_class): finger 0 > 0.5, finger 1 > 0.5, mean "
                       "of fingers 2-4 > 0.5; flex_scale 1.0",
        "frames": {"drawn": draws, "per_class": per_class,
                   "resolution": [int(v) for v in ds_cfg["img_dims"]],
                   "palette_as_flagship": colors == flagship_colors},
        "router": {"depth": flagship_v2.FINE_DEPTH,
                   "trees": flagship_v2.TREES, "classes": EXPERTS + 1,
                   "pct_match": round(router.pct_match, 4),
                   "train_seconds": round(t_router, 1)},
        "experts": {"depth": flagship_v2.FINE_DEPTH,
                    "trees": flagship_v2.TREES, "classes": PART_CLASSES,
                    "pct_match": [round(e.pct_match, 4) for e in experts],
                    "train_seconds": round(t_experts, 1)},
        "held_out": heldout,
        "build_seconds": round(seconds, 1),
        "files_mb": {f: round(os.path.getsize(os.path.join(OUT, f)) / 1e6, 3)
                     for f in sorted(os.listdir(OUT))
                     if f.endswith((".npy", ".gz"))},
    }
    with open(os.path.join(OUT, "RESULTS.json"), "w") as f:
        json.dump(summary, f, indent=1)
    return summary


def main(argv=None, device=None, intrin=None, log=print):
    """The five steps on the card (``device``: another device; ``intrin``:
    another camera than the D415 at 848x480).  Returns the summary."""
    argv = sys.argv[1:] if argv is None else list(argv)
    device = resolve_device(device)
    n_train = int(argv[0]) if len(argv) > 0 else TRAIN_PER_CLASS
    n_test = int(argv[1]) if len(argv) > 1 else TEST_PER_CLASS
    intrin = intrin or CameraIntrinsics.d415()
    t0 = time.time()
    frames, split, ds_cfg, draws = step_frames(intrin, n_train, n_test,
                                               device=device, log=log)
    router, t_router = step_router(frames, split, device=device, log=log)
    experts, t_experts = step_experts(frames, split, device=device, log=log)
    model = step_assemble(router, experts, ds_cfg, device=device)
    heldout = step_heldout(model, frames, split, device=device, log=log)
    summary = step_write(split, frames, ds_cfg, draws, router, t_router,
                         experts, t_experts, heldout, time.time() - t0)
    log(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
