"""Synthetic fixtures: random-but-valid forests, depth frames, and tiny
labeled datasets.  Stands in for the reference's recorded .bag sessions
(SURVEY.md §4: recorded-input playback is the reference's de-facto integration
fixture; we generate deterministic synthetic equivalents)."""

from __future__ import annotations

import numpy as np

MAX_UINT16 = 65535


def random_tree_flat(rng, max_depth, num_classes, leaf_prob=0.3, off_mag=20000.0):
    """A random packed tree (total_nodes, 7+2C) float32 with reference
    semantics: l/r_next == -1 -> descend, 0 -> leaf; last level all leaves."""
    total = (1 << max_depth) - 1
    els = 7 + 2 * num_classes
    tree = np.zeros((total, els), dtype=np.float32)
    # track reachable internal nodes level by level
    for level in range(max_depth):
        for g in range(1 << level):
            flat = (1 << level) - 1 + g
            u = rng.uniform(-off_mag, off_mag, size=2)
            v = rng.uniform(-off_mag, off_mag, size=2)
            thresh = rng.uniform(-300, 300)
            tree[flat, 0:2] = u
            tree[flat, 2:4] = v
            tree[flat, 4] = thresh
            for side in (0, 1):
                is_leaf = (level == max_depth - 1) or (rng.random() < leaf_prob)
                tree[flat, 5 + side] = 0.0 if is_leaf else -1.0
                if is_leaf:
                    pdf = rng.random(num_classes).astype(np.float32)
                    pdf[0] = 0.0  # class 0 = background, never dominant
                    tree[flat, 7 + side * num_classes : 7 + (side + 1) * num_classes] = pdf
    return tree


def random_forest_flat(rng, num_trees, max_depth, num_classes, **kw):
    return np.stack(
        [random_tree_flat(rng, max_depth, num_classes, **kw) for _ in range(num_trees)]
    )


def random_depth_image(rng, n, h, w, missing_frac=0.15, far_frac=0.05,
                       lo=500, hi=3000):
    """Random uint16 depth with 0 and 65535 sentinels sprinkled in."""
    d = rng.integers(lo, hi, size=(n, h, w)).astype(np.uint16)
    m = rng.random((n, h, w))
    d[m < missing_frac] = 0
    d[m > 1.0 - far_frac] = MAX_UINT16
    return d


def blob_scene(h=60, w=106, blobs=((15, 20, 8), (40, 80, 10))):
    """A small depth image with distinct blobs (for grouping tests):
    list of (cy, cx, radius)."""
    d = np.zeros((h, w), dtype=np.uint16)
    yy, xx = np.mgrid[0:h, 0:w]
    for cy, cx, r in blobs:
        d[(yy - cy) ** 2 + (xx - cx) ** 2 <= r * r] = 1500
    return d


def synthetic_hand_dataset(rng, n=6, h=32, w=48, num_classes=4):
    """Tiny labeled dataset: depth bands map to classes, so a depth-difference
    forest can actually learn it.  Returns (depth, labels) uint16 arrays.
    Class 0 = background (label 0, depth 0)."""
    depth = np.zeros((n, h, w), dtype=np.uint16)
    labels = np.zeros((n, h, w), dtype=np.uint16)
    for i in range(n):
        # random rectangles per class at distinct depth ranges
        for c in range(1, num_classes):
            y0 = int(rng.integers(0, h - 8))
            x0 = int(rng.integers(0, w - 8))
            hh = int(rng.integers(4, 8))
            ww = int(rng.integers(4, 8))
            d = int(500 + 400 * c + rng.integers(0, 80))
            depth[i, y0 : y0 + hh, x0 : x0 + ww] = d
            labels[i, y0 : y0 + hh, x0 : x0 + ww] = c
    return depth, labels


def layered_cfg_fixture(tmpdir, rng, num_classes_coarse=3, num_classes_fine=4):
    """Write a two-layer model directory + cfg JSON in the reference schema.

    Layer 0: coarse model (classes: 1=hand, 2=arm). Layer 1: fine model
    filtered to layer-0 class 1. Conditions: coarse class 2 -> final 1;
    coarse class 1 -> look at layer 1; fine classes 1..3 -> final 2..4.
    """
    import json
    import os

    f0 = random_forest_flat(rng, 2, 4, num_classes_coarse)
    f1 = random_forest_flat(rng, 2, 4, num_classes_fine)
    np.save(os.path.join(tmpdir, "m0.npy"), f0)
    np.save(os.path.join(tmpdir, "m1.npy"), f1)
    num_final = num_classes_fine  # 1 + (fine - 1)
    conditions = [[1, 2], [0, 1]] + [[0, 2 + i] for i in range(num_classes_fine - 1)]
    cfg = {
        "layers": [
            {"model": "m0.npy"},
            {"model": "m1.npy", "filter_model": 0, "filter_model_class": 1},
        ],
        "conditions": conditions,
        "label_colors": [[(37 * (i + 1)) % 256, (91 * (i + 1)) % 256,
                          (151 * (i + 1)) % 256, 255] for i in range(num_final)],
    }
    path = os.path.join(tmpdir, "model_cfg.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


# The hand-image and label cases (ops/hand_images_cuda.py): frames H x W,
# crops CH x CW; per variant (pairs' frames B, depth_mm_level, labels_reduce,
# crop origins, zeroing, the frame index that picks each pair's frame).
HAND_H, HAND_W, HAND_CH, HAND_CW = 48, 80, 32, 48
HAND_GUARD_SPREAD, HAND_GUARD_FRAC = 1500, 0.25
HAND_VARIANTS = {
    "b1_l3_r2_origin0": (1, 3, 2, "zero", False, None),
    "b1_l1_r1_edge": (1, 1, 1, "edge", False, None),
    "b16_l3_r1_edge_zeroed": (16, 3, 1, "edge", True, None),
    "b16_l1_r2_past_zeroed_frames": (16, 1, 2, "past", True, (2, 2, 7, 0)),
}


def hand_image_case(rng, body, guard, variant):
    """Inputs of ``hand_images`` and ``place_labels`` for one case, as numpy
    arrays and keywords.  body "crop" or "full"; guard "off", "flagged"
    (the even frames' depth is noise over the full range, so their
    unzeroed hands are flagged) or "clean" (every frame a smooth surface,
    nothing flagged).  Origins "zero" (both hands at 0), "edge" (the right
    hand at the frame's far corner, the left at mirrored 0, that is, the
    far right edge of the unmirrored frame) or "past" (a 2**level step
    past the far corner: windows partly outside the frame, the left hand's
    unmirrored origin negative).  Zeroing: odd pairs are muted (crop) or
    not kept (full).  Returns dict(depth1 (B, H, W), grown (B, Hs, Ws),
    level, r, kw (hand_images' keywords, numpy), labels (pairs, 2, lh, lw),
    place_kw (place_labels' keywords, numpy))."""
    b, level, r, origin, zeroed, frames = HAND_VARIANTS[variant]
    h, w, ch, cw, f = HAND_H, HAND_W, HAND_CH, HAND_CW, 1 << level
    yy, xx = np.mgrid[0:h, 0:w]
    depth1 = np.broadcast_to(2000 + 3 * yy + xx, (b, h, w)).astype(np.int32)
    depth1 = np.where(rng.random((b, h, w)) < 0.1, 0, depth1)
    depth1 = np.where(rng.random((b, h, w)) < 0.02, MAX_UINT16, depth1)
    if guard == "flagged":
        depth1[0::2] = rng.integers(1, 60000, depth1[0::2].shape)
    hs, ws = -(-h // f), -(-w // f)
    grown = rng.integers(0, 3, (b, hs, ws)).astype(np.int32)
    pairs = b if frames is None else len(frames)
    kw = {}
    if frames is not None:
        kw["frames"] = np.asarray(frames, np.int64)
    if zeroed:
        odd = np.arange(pairs) % 2 == 1
        kw["mute" if body == "crop" else "keep"] = (
            odd if body == "crop" else ~odd)
    if guard != "off":
        kw["guard"] = (r, HAND_GUARD_SPREAD, HAND_GUARD_FRAC)
    place_kw = {}
    if body == "crop":
        far_y, far_x = h - ch, w - cw
        oys, oxs = {"zero": ((0, 0), (0, 0)),
                    "edge": ((far_y, 0), (far_x, 0)),
                    "past": ((far_y + f, far_y + f), (far_x + f, far_x + f)),
                    }[origin]
        oys = np.tile(np.asarray(oys, np.int32), (pairs, 1))
        oxs = np.tile(np.asarray(oxs, np.int32), (pairs, 1))
        kw.update(window=(ch, cw), origins=(oys, oxs))
        place_kw.update(origins=(oys, oxs), canvas=(h // r, w // r))
        lh, lw = ch // r, cw // r
    else:
        lh, lw = h // r, w // r
    labels = rng.integers(1, 8, (pairs, 2, lh, lw)).astype(np.int32)
    labels = np.where(rng.random(labels.shape) < 0.3, MAX_UINT16, labels)
    return dict(depth1=depth1, grown=grown, level=level, r=r, kw=kw,
                labels=labels.astype(np.int32), place_kw=place_kw)


def as_tensors(kw, device=None):
    """A hand-image case's numpy keywords (``kw`` or ``place_kw``) as
    tensors on ``device``: arrays and the origins pair converted, the rest
    as they are."""
    import torch

    out = {}
    for key, v in kw.items():
        if key == "origins":
            out[key] = tuple(torch.as_tensor(o, device=device) for o in v)
        elif isinstance(v, np.ndarray):
            out[key] = torch.as_tensor(v, device=device)
        else:
            out[key] = v
    return out
