"""Truncate the fine forest to depth Dt with an exact leaf-pdf refit, and
measure what it costs in held-out accuracy (counterpart of the
repository's ``scripts/truncate_fine.py``).

Depth is a serving lever: the layered kernel walks one level per step, so
a shallower fine layer takes fewer dependent steps.  Rather than retrain,
the trained fine forest is cut at depth Dt and the new terminal pdfs are
refit from the training set:

  pdf(new leaf g*2+side at level Dt-1) =
      normalized label histogram of the training pixels that reach node g
      at level Dt-1 and branch to ``side``, with the trainer's 99.9 %
      cutoff one-hot rule applied (``train/trainer.py`` finalize).

This is what the trainer would have written had it stopped at depth Dt
with the same splits above (its terminal pdfs are the same histograms).

Self-check: at level Dt-1 the original tree also has terminal leaves.  The
same walk must reproduce their stored pdfs (the trainer computed them from
the same pixels); ``pdf_check`` reports the worst deviation over the
terminals that are not double leaves (a no-gain node writes its parent's
pdf to both sides, which is not a side histogram).  The walk computes the
probe offsets with the plain evaluator's feature
(``ops/forest_eval.depth_difference_feature``), whose division rounds as
the training kernel's (B4) and the single-forest kernel's (B1) do, so on
one machine the refit reproduces the trainer's leaves exactly.

Usage, after the flagship's dataset exists at ``B3D_V2_DS``:

    python -m beats3d_tpu_torch.scripts.truncate_fine [Dt ...] \\
        [--refit-only | --acc-only]        # default Dt: 15 14 13 12

Reads the fine layer from ``B3D_V2_OUT``/m1.npy.gz (default
``build/flagship_v2``, where ``scripts.flagship_v2`` writes it), writes
``TRUNC_SWEEP.json`` and the truncated model directories
``trunc_fine_D{Dt}/`` there.  Runs on the card; ``B3D_TRUNC_CPU=1`` runs it
on the CPU.
"""

from __future__ import annotations

import gzip
import io
import json
import os
import shutil
import sys
import time

import numpy as np
import torch

from ..data.dataset import DatasetConfig
from ..models.forest import PackedForest
from ..ops.forest_eval import depth_difference_feature
from ..train.trainer import CUTOFF_THRESH as CUTOFF
from ..models import load_flagship
from . import flagship_v2 as v2
from . import resolve_device
from .flagship_v2 import eval_chunked


def load_fine_flat():
    with gzip.open(os.path.join(v2.OUT, "m1.npy.gz"), "rb") as f:
        return np.load(io.BytesIO(f.read()))


def walk_ids(depth, tables, dt):
    """Per-lane (new-leaf id, active, original terminal id, terminal here)
    after walking levels 0..dt-1 of (N, H, W) int32 ``depth``; each array
    is (N, H, W, T), ids int32.

    The traversal is the plain evaluator's (``forest_pdf_sum``): the same
    feature, floor rounding and child flags.  For each (pixel, tree) lane
    it returns the would-be child id 2g+side at level dt-1 and whether the
    lane was still descending there (the lanes a depth-dt truncation turns
    into new-leaf samples), or ended in a stored leaf there.  No pixel
    eligibility is applied: the caller keeps the trainer's (labels > 0).
    """
    n, h, w = depth.shape
    dev = depth.device
    num_trees = tables[0][0].shape[0]
    yd = torch.arange(h, dtype=torch.int32, device=dev).view(1, h, 1, 1)
    xd = torch.arange(w, dtype=torch.int32, device=dev).view(1, 1, w, 1)
    d_center_t = depth[..., None]
    g = torch.zeros((n, h, w, num_trees), dtype=torch.int64, device=dev)
    done = torch.zeros(g.shape, dtype=torch.bool, device=dev)
    tree_base = torch.arange(num_trees, dtype=torch.int64, device=dev)
    for j in range(dt):
        uv, thresh, lr_next, _ = tables[j]
        g_level = 1 << j
        gidx = tree_base * g_level + g
        uv_g = uv.reshape(num_trees * g_level, 4)[gidx]
        th_g = thresh.reshape(num_trees * g_level)[gidx]
        f = depth_difference_feature(depth, yd, xd, d_center_t,
                                     uv_g[..., 0:2], uv_g[..., 2:4], 1.0)
        side = (~(f < th_g)).to(torch.int64)
        descend = lr_next.reshape(-1)[gidx * 2 + side] == -1
        live = ~done
        if j == dt - 1:
            leaf = (2 * g + side).to(torch.int32)
            return leaf, live & descend, leaf, live & ~descend
        g = torch.where(live & descend, 2 * g + side, g)
        done = done | (live & ~descend)
    raise ValueError(f"walk_ids: depth {dt}")


def refit_counts(flat, dt, train_depth, train_labels, chunk=2,
                 device="cuda"):
    """Histogram the training labels into the depth-dt new leaves and, for
    the check, into the original level-(dt-1) terminal leaves: two
    (T, 2**dt, C) int64 arrays.

    The histograms stay on ``device`` in int64 across the ``chunk``-frame
    chunks (one leaf can collect more than 2**24 pixels of a training
    set); only labelled pixels count, as in the trainer."""
    device = torch.device(device)
    t, _, els = flat.shape
    c = (els - 7) // 2
    nleaf = 1 << dt
    forest = torch.as_tensor(np.ascontiguousarray(flat[:, :nleaf - 1],
                                                  dtype=np.float32))
    tables = PackedForest.from_flat(forest.to(device)).tables()
    tree_off = torch.arange(t, dtype=torch.int64, device=device) * nleaf * c
    counts = torch.zeros(t * nleaf * c, dtype=torch.int64, device=device)
    vcounts = torch.zeros_like(counts)
    for lo in range(0, train_depth.shape[0], chunk):
        d = torch.as_tensor(
            train_depth[lo : lo + chunk].astype(np.int32)).to(device)
        lab = torch.as_tensor(
            train_labels[lo : lo + chunk].astype(np.int64)).to(device)[..., None]
        ids, act, tids, there = walk_ids(d, tables, dt)
        labeled = lab > 0
        for acc, idz, msk in ((counts, ids, act), (vcounts, tids, there)):
            key = tree_off + idz.to(torch.int64) * c + lab
            acc.index_add_(0, key.reshape(-1),
                           (msk & labeled).reshape(-1).to(torch.int64))
    return (counts.reshape(t, nleaf, c).cpu().numpy(),
            vcounts.reshape(t, nleaf, c).cpu().numpy())


def pdf_check(flat, dt, vcounts):
    """Hold the refit walk against the trainer's output: the refit
    histograms of the original terminal leaves at level dt-1 against their
    stored pdfs.  Mixed (fractional) leaves must match to float32
    rounding, cutoff one-hot leaves to (1 - CUTOFF) (the trainer rounded a
    >= 99.9 % histogram up to 1.0).  Double leaves are left out: their
    stored pdf is the parent's histogram by design.

    Returns a dict: the worst mixed and cutoff deviations, the leaves
    checked and mixed, and the leaves deviating by more than 0.01 with the
    pixels in them (a few pixels landing one node over, against a walk
    that diverges)."""
    t, _, els = flat.shape
    c = (els - 7) // 2
    base = (1 << (dt - 1)) - 1
    lvl = flat[:, base : base + (1 << (dt - 1))]
    out = {"dev_mixed": 0.0, "dev_cutoff": 0.0, "checked": 0, "mixed": 0,
           "bad_leaves": 0, "bad_pixels": 0, "pixels": 0}
    for tt in range(t):
        lr = np.floor(lvl[tt, :, 5:7]).astype(np.int32)
        lpdf = lvl[tt, :, 7 : 7 + c]
        rpdf = lvl[tt, :, 7 + c : 7 + 2 * c]
        dbl = (lr[:, 0] != -1) & (lr[:, 1] != -1) & (
            np.abs(lpdf - rpdf).max(axis=1) == 0.0)
        for side, pdf in ((0, lpdf), (1, rpdf)):
            term = (lr[:, side] != -1) & ~dbl
            for gg in np.nonzero(term)[0]:
                cnt = vcounts[tt, 2 * gg + side]
                s = cnt.sum()
                if s == 0:
                    continue
                dev = float(np.abs(cnt / s - pdf[gg]).max())
                out["checked"] += 1
                out["pixels"] += int(s)
                if dev > 0.01:
                    out["bad_leaves"] += 1
                    out["bad_pixels"] += int(s)
                if pdf[gg].max() >= 1.0:
                    out["dev_cutoff"] = max(out["dev_cutoff"], dev)
                else:
                    out["dev_mixed"] = max(out["dev_mixed"], dev)
                    out["mixed"] += 1
    return out


def truncate(flat, dt, counts):
    """Depth-dt flat array with refit terminal pdfs (trainer semantics) and
    the count of new leaves no training pixel reached (their pdf is 0)."""
    t, _, els = flat.shape
    c = (els - 7) // 2
    total = (1 << dt) - 1
    out = flat[:, :total].copy()
    base = (1 << (dt - 1)) - 1
    empty = 0
    for tt in range(t):
        lvl = out[tt, base:total]
        lr = np.floor(lvl[:, 5:7]).astype(np.int32)
        for gg in np.nonzero((lr[:, 0] == -1) | (lr[:, 1] == -1))[0]:
            for side in (0, 1):
                if lr[gg, side] != -1:
                    continue
                cnt = counts[tt, 2 * gg + side].astype(np.float64)
                s = cnt.sum()
                pdf0 = 7 + side * c
                lvl[gg, 5 + side] = 0.0
                lvl[gg, pdf0 : pdf0 + c] = 0.0
                if s == 0:
                    empty += 1
                    continue
                frac = cnt / s
                cut = np.nonzero(frac >= CUTOFF)[0]
                if cut.size:
                    lvl[gg, pdf0 + cut[0]] = 1.0
                else:
                    lvl[gg, pdf0 : pdf0 + c] = frac.astype(np.float32)
    return out, empty


def heldout_acc(model_dir, test_depth, test_labels, device="cuda"):
    """Layered held-out pct_match (``flagship_v2`` step 5's semantics: full
    resolution, kernel K1 on a card), over the labelled test pixels."""
    lab = eval_chunked(load_flagship(device, model_dir), test_depth)
    labeled = test_labels > 0
    return float((lab[labeled] == test_labels[labeled]).mean())


def write_model_dir(mdir, trunc, src=None):
    """A model directory: ``src``'s coarse layer and config beside the
    truncated fine layer ``trunc`` as m1.npy."""
    src = src or v2.OUT
    os.makedirs(mdir, exist_ok=True)
    for name in ("m0.npy", "model_cfg.json"):
        shutil.copy(os.path.join(src, name), os.path.join(mdir, name))
    np.save(os.path.join(mdir, "m1.npy"), trunc)


def sweep_depth(flat, dt, train_depth, train_labels, device):
    """One depth of the sweep: refit counts, the check against the
    trainer's leaves, the truncated forest.  Returns (row, truncated)."""
    t0 = time.time()
    counts, vcounts = refit_counts(flat, dt, train_depth, train_labels,
                                   device=device)
    chk = pdf_check(flat, dt, vcounts)
    trunc, empty = truncate(flat, dt, counts)
    row = {"depth": dt, "refit_check": chk, "empty_leaves": empty,
           "refit_s": round(time.time() - t0, 1),
           "refit_platform": torch.device(device).type}
    return row, trunc


def main(argv=None):
    """Phases, as in the repository's script: ``--refit-only`` walks,
    histograms and writes the truncated model directories; ``--acc-only``
    measures the held-out accuracy of directories already written; by
    default both.  Returns the sweep's record."""
    argv = sys.argv[1:] if argv is None else list(argv)
    args = [a for a in argv if not a.startswith("--")]
    refit_only = "--refit-only" in argv
    acc_only = "--acc-only" in argv
    device = resolve_device("cpu" if os.environ.get("B3D_TRUNC_CPU")
                            else None)

    dts = [int(a) for a in args] or [15, 14, 13, 12]
    # ordered=True: the same split in every process; the test set is the
    # datagen's final 16 frames (the unseen-pose stream), the training set
    # the 120 the fine layer trained on
    train_data, test_data = DatasetConfig.multiple(v2.DS, [
        (120, 4, "train"), (16, None, "test")], ordered=True)
    test_depth = test_data.get_depth_block(0)
    test_labels = test_data.get_labels_block(0)

    flat = load_fine_flat()
    out = os.path.join(v2.OUT, "TRUNC_SWEEP.json")
    if acc_only and os.path.exists(out):
        with open(out) as f:
            results = json.load(f)
    else:
        results = {"baseline_depth": int(np.log2(flat.shape[1] + 1)),
                   "sweep": []}

    if not acc_only:
        train_depth = np.concatenate([
            train_data.get_depth_block(i)
            for i in range(train_data.num_image_blocks)])
        train_labels = np.concatenate([
            train_data.get_labels_block(i)
            for i in range(train_data.num_image_blocks)]).astype(np.int64)
        for dt in dts:
            row, trunc = sweep_depth(flat, dt, train_depth, train_labels,
                                     device)
            row["model_dir"] = os.path.join(v2.OUT, f"trunc_fine_D{dt}")
            write_model_dir(row["model_dir"], trunc)
            results["sweep"].append(row)
            print(f"[trunc] {row}", flush=True)

    if not refit_only:
        base_acc = heldout_acc(v2.OUT, test_depth, test_labels, device)
        results["baseline_acc"] = round(base_acc, 4)
        print(f"[trunc] baseline D={results['baseline_depth']} held-out "
              f"acc {base_acc:.4f}", flush=True)
        for row in results["sweep"]:
            acc = heldout_acc(row["model_dir"], test_depth, test_labels,
                              device)
            row["acc"] = round(acc, 4)
            row["acc_delta"] = round(acc - base_acc, 4)
            print(f"[trunc] D={row['depth']} acc={acc:.4f} "
                  f"(delta {acc - base_acc:+.4f})", flush=True)

    with open(out, "w") as f:
        json.dump(results, f, indent=1)
    print(f"[trunc] wrote {out}", flush=True)
    return results


if __name__ == "__main__":
    main()
