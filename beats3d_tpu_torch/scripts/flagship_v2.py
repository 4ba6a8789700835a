"""Build the flagship layered model from articulated synthetic hands
(counterpart of the repository's ``scripts/flagship_v2.py``, which made
the committed ``models/flagship``):

1. datagen: 848x480 frames of an articulated hand (palm disk and five
   jointed fingers, random pose) through ``data.datagen.LiveDataConvert``
   (colour-EM labels, plane fit, augmentation, smoothing); the training
   frames from one rng stream, the held-out frames (unseen poses) from a
   disjoint one;
2. the coarse hand/background layer (D=8, T=4), trained from zlib blocks
   streamed per use (``data.blocks.CompressedDataset``);
3. the fine 6-class layer (D=16, T=4), resident on the device unless
   ``B3D_V2_STREAM_FINE`` is set;
4. assembly: ``m0.npy``, ``m1.npy`` and ``model_cfg.json``;
5. held-out accuracy on the unseen poses (kernel K1 against its plain
   version), ``golden_eval.npz``, ``m1.npy.gz`` and ``RESULTS.json``.

Run on the card:

    python -m beats3d_tpu_torch.scripts.flagship_v2 [N_train] [N_test]

Writes the model to ``B3D_V2_OUT`` (default ``build/flagship_v2``; the
committed ``models/flagship`` is the reference and is never the default)
and the dataset's PNGs to ``B3D_V2_DS`` (default ``build/flagship_v2_ds``;
PNGs need Pillow).  ``B3D_V2_REUSE`` trains on an existing dataset there,
``B3D_V2_DETAIL``, ``B3D_V2_NOISE`` and ``B3D_V2_RIGGED`` change the
generated hands as ``data.synth.articulated_scene`` describes.  Each step
is a function of its own, so a caller without Pillow (the card machine)
can keep the frames in memory (``step_datagen(..., keep=True)``).
"""

from __future__ import annotations

import gzip
import json
import os
import resource
import shutil
import sys
import time

import numpy as np
import torch

from ..data.blocks import CompressedDataset
from ..data.datagen import DatagenConfig, LiveDataConvert
from ..data.dataset import ArrayDataset, DatasetConfig
from ..data.synth import articulated_scene
from ..models import load_flagship
from ..models.layered import run_layered
from ..ops import forest_eval_cuda
from ..train import train_forest
from ..utils import CameraIntrinsics
from . import resolve_device

OUT = os.environ.get("B3D_V2_OUT", os.path.join("build", "flagship_v2"))
DS = os.environ.get("B3D_V2_DS", os.path.join("build", "flagship_v2_ds"))
FINE_DEPTH = 16
COARSE_DEPTH = 8
TREES = 4
PROPOSALS = 128
PROPOSALS_BLOCK = 64
IMAGES_PER_BLOCK = 4
# the recipe's seeds: converter, training poses, unseen poses, trainers
CONVERTER_SEED, TRAIN_SEED, TEST_SEED = 3, 1001, 9901
COARSE_SEED, FINE_SEED = 7, 13
MAX_UINT16 = 65535


def scene_v2(intrin, rng):
    """One full-resolution articulated-hand frame (a single right hand in
    a random pose), (depth uint16, colour uint8).  ``B3D_V2_DETAIL`` and
    ``B3D_V2_NOISE`` (floats) add surface relief and D415-style sensor
    noise, ``B3D_V2_RIGGED`` (0/1) the rigged hand."""
    return articulated_scene(
        intrin, rng, two_hands=False,
        detail=float(os.environ.get("B3D_V2_DETAIL", "0")),
        noise_scale=float(os.environ.get("B3D_V2_NOISE", "0")),
        rigged=bool(int(os.environ.get("B3D_V2_RIGGED", "0"))),
    )


def rss_gb():
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6


def eval_chunked(model, depth, plain=False):
    """Full-resolution layered labels of (N, H, W) uint16 ``depth``, two
    frames at a time, as uint16: kernel K1 on a card (its plain version on
    the CPU), or with ``plain`` the plain version on the model's device."""
    outs = []
    for lo in range(0, depth.shape[0], 2):
        d = torch.as_tensor(
            depth[lo : lo + 2].astype(np.int32)).to(model.device)
        if plain:
            o = forest_eval_cuda.evaluate_layered_plain(
                d, model.layers, model.conditions, labels_reduce=1)
        else:
            o = run_layered(d, model, labels_reduce=1)
        outs.append(o.cpu().numpy().astype(np.uint16))
    return np.concatenate(outs)


def recipe_converter(out_dir, intrin, max_images, *, device, log=print):
    """The recipe's converter (colour-EM labels, plane fit, augmentation,
    smoothing) writing to ``out_dir``, its rng from CONVERTER_SEED."""
    cfg = DatagenConfig(
        num_colors=6, color_em_tries=6, color_em_iterations=24,
        plane_candidates=8192, plane_z_threshold=40.0,
        scale_variance=0.04, gaussian_noise=1.5,
        max_images=max_images,
    )
    return LiveDataConvert(out_dir, intrin, cfg,
                           rng=np.random.default_rng(CONVERTER_SEED),
                           log=log, device=device)


def step_datagen(intrin, n_train, n_test, *, device, keep=False, log=print):
    """Step 1: the recipe's frames through the converter.  Returns
    (dataset config, frames): with ``keep`` the frames stay in memory as
    (depth, labels) uint16 pairs, depth as the PNGs store it (missing =
    65535), and no PNG is written; else the PNGs and config.json go to
    ``DS`` and frames is None.  With ``B3D_V2_REUSE`` and a dataset at
    ``DS``, that dataset is used (the rng streams are seeded, so it is
    what this step would write)."""
    t0 = time.time()
    if not keep and os.environ.get("B3D_V2_REUSE") and os.path.exists(
            os.path.join(DS, "config.json")):
        with open(os.path.join(DS, "config.json")) as f:
            ds_cfg = json.load(f)
        assert ds_cfg["num_images"] == n_train + n_test, \
            "dataset size mismatch"
        log(f"[datagen] reusing {DS} ({n_train + n_test} frames)")
        return ds_cfg, None
    if os.path.exists(DS):
        shutil.rmtree(DS)
    conv = recipe_converter(DS, intrin, n_train + n_test, device=device,
                            log=log)
    frames = None
    if keep:
        frames = []
        conv._save = lambda d, l, s: frames.append(
            (np.where(d == 0, MAX_UINT16, d).astype(np.uint16), l))
    rng_train = np.random.default_rng(TRAIN_SEED)
    rng_test = np.random.default_rng(TEST_SEED)   # unseen poses
    for t in range(n_train + n_test):
        rng = rng_train if t < n_train else rng_test
        depth, color = scene_v2(intrin, rng)
        conv.process_frame(depth, color, depth_timestamp=t / 90.0,
                           color_timestamp=t / 90.0 + 0.002)
        if (t + 1) % 20 == 0:
            log(f"[datagen] {t + 1}/{n_train + n_test} frames "
                f"({time.time() - t0:.0f}s)")
    ds_cfg = conv.finish()
    log(f"[datagen] {ds_cfg['num_images']} full-res articulated frames in "
        f"{time.time() - t0:.1f}s")
    return ds_cfg, frames


def load_split(n_train, n_test, frames=None):
    """(train, test) in file order: the unseen-pose frames come last, so
    the test set is exactly them, and every process gets the split that
    ``truncate_fine`` refits against.  From ``DS`` (PNGs), or from
    ``step_datagen``'s frames kept in memory."""
    if frames is None:
        return DatasetConfig.multiple(DS, [
            (n_train, IMAGES_PER_BLOCK, "train"),
            (n_test, None, "test"),
        ], ordered=True)
    depth = np.stack([d for d, _ in frames])
    labels = np.stack([l for _, l in frames])
    classes = 7                      # background + the 6 palette colours
    return (ArrayDataset(depth[:n_train], labels[:n_train], classes,
                         images_per_block=IMAGES_PER_BLOCK),
            ArrayDataset(depth[n_train:], labels[n_train:], classes))


def compression_stats(comp_train):
    return {
        "depth_ratio": round(comp_train.depth.compression_ratio, 1),
        "labels_ratio": round(comp_train.labels.compression_ratio, 1),
        "depth_mb": round(comp_train.depth.compressed_bytes / 1e6, 1),
        "labels_mb": round(comp_train.labels.compressed_bytes / 1e6, 1),
        "raw_mb": round(
            (comp_train.depth.raw_bytes + comp_train.labels.raw_bytes) / 1e6,
            1),
    }


def to_coarse(d):
    """Hand (1) against background (0) of a dataset, in memory."""
    depth = np.concatenate(
        [d.get_depth_block(i) for i in range(d.num_image_blocks)])
    labels = np.concatenate(
        [d.get_labels_block(i) for i in range(d.num_image_blocks)])
    return ArrayDataset(
        depth, (labels > 0).astype(np.uint16), 2,
        images_per_block=min(IMAGES_PER_BLOCK, depth.shape[0]))


def step_coarse(train_data, test_data, *, device, log=print):
    """Step 2: the coarse layer from streamed zlib blocks.  Returns
    (forest, seconds)."""
    t0 = time.time()
    coarse = train_forest(
        CompressedDataset(to_coarse(train_data)), to_coarse(test_data),
        num_random_features=PROPOSALS, proposals_per_block=PROPOSALS_BLOCK,
        images_per_block=IMAGES_PER_BLOCK, max_tree_depth=COARSE_DEPTH,
        trees_in_forest=TREES, trees_to_try=TREES,
        rng=np.random.default_rng(COARSE_SEED), streaming=True,
        device=device, log=log,
    )
    t = time.time() - t0
    log(f"[coarse] D={COARSE_DEPTH} T={TREES} pct_match="
        f"{coarse.pct_match:.4f} in {t:.1f}s  rss={rss_gb():.2f}G")
    return coarse, t


def step_fine(comp_train, test_data, *, device, log=print):
    """Step 3: the fine layer at the flagship's depth, resident on the
    device (``B3D_V2_STREAM_FINE``: blocks streamed per use), resumable
    per candidate tree from ``DS``/ckpt_fine.  Returns (forest,
    seconds)."""
    t0 = time.time()
    fine = train_forest(
        comp_train, test_data,
        num_random_features=PROPOSALS, proposals_per_block=PROPOSALS_BLOCK,
        images_per_block=IMAGES_PER_BLOCK, max_tree_depth=FINE_DEPTH,
        trees_in_forest=TREES, trees_to_try=TREES,
        rng=np.random.default_rng(FINE_SEED),
        streaming=bool(os.environ.get("B3D_V2_STREAM_FINE")),
        checkpoint_dir=os.path.join(DS, "ckpt_fine"),
        device=device, log=log,
    )
    t = time.time() - t0
    log(f"[fine] D={FINE_DEPTH} T={TREES} pct_match={fine.pct_match:.4f} "
        f"in {t:.1f}s  rss={rss_gb():.2f}G")
    return fine, t


def step_assemble(coarse, fine, ds_cfg, *, device):
    """Step 4: the layered model in the reference's artifact format under
    ``OUT``; returns it loaded on ``device``."""
    os.makedirs(OUT, exist_ok=True)
    np.save(os.path.join(OUT, "m0.npy"), coarse.data)
    np.save(os.path.join(OUT, "m1.npy"), fine.data)
    layered_cfg = {
        "layers": [
            {"model": "m0.npy"},
            {"model": "m1.npy", "filter_model": 0, "filter_model_class": 1},
        ],
        "conditions": [[1, 1]] + [[0, i + 1] for i in range(6)],
        "label_colors": [
            [int(v) for v in ds_cfg["id_to_color"][str(i + 1)]]
            for i in range(6)
        ],
    }
    with open(os.path.join(OUT, "model_cfg.json"), "w") as f:
        json.dump(layered_cfg, f, indent=1)
    return load_flagship(device, OUT)


def step_heldout(model, test_data, *, log=print):
    """Step 5's evaluation: the layered labels of the unseen poses by K1
    and by its plain version.  Returns (K1 labels, mismatches, held-out
    pct_match)."""
    test_depth = test_data.get_depth_block(0)
    test_labels = test_data.get_labels_block(0)
    lab_plain = eval_chunked(model, test_depth, plain=True)
    lab_k1 = eval_chunked(model, test_depth)
    mism = int((lab_plain != lab_k1).sum())
    labeled = test_labels > 0
    acc = float((lab_k1[labeled] == test_labels[labeled]).mean())
    log(f"[layered] K1 vs plain mismatches: {mism}; held-out (unseen "
        f"poses) pct_match: {acc:.4f}")
    return lab_k1, mism, acc


def step_write(test_data, lab_k1, mism, acc, ds_cfg, comp_stats, coarse,
               t_coarse, fine, t_fine):
    """Step 5's outputs under ``OUT``: ``golden_eval.npz`` (the first two
    unseen frames and their K1 labels), ``m1.npy.gz`` in m1.npy's place,
    and ``RESULTS.json`` (keeping an earlier session record).  Returns the
    summary."""
    np.savez_compressed(
        os.path.join(OUT, "golden_eval.npz"),
        depth=test_data.get_depth_block(0)[:2], labels=lab_k1[:2])
    with open(os.path.join(OUT, "m1.npy"), "rb") as src, gzip.open(
            os.path.join(OUT, "m1.npy.gz"), "wb") as dst:
        shutil.copyfileobj(src, dst)
    os.remove(os.path.join(OUT, "m1.npy"))

    old_session = None
    try:
        with open(os.path.join(OUT, "RESULTS.json")) as f:
            old_session = json.load(f).get("bz3d_session")
    except (OSError, ValueError):
        pass
    summary = {
        "dataset": {
            "images": int(ds_cfg["num_images"]),
            "resolution": [int(v) for v in ds_cfg["img_dims"]],
            "generator": "articulated 3-segment-finger hand, random pose "
                         "(beats3d_tpu_torch.scripts.flagship_v2), "
                         "splat-rendered (ops/render.py)",
            "held_out": "unseen poses (disjoint rng stream)",
        },
        "coarse": {"depth": COARSE_DEPTH, "trees": TREES,
                   "pct_match": round(coarse.pct_match, 4),
                   "train_seconds": round(t_coarse, 1)},
        "fine": {"depth": FINE_DEPTH, "trees": TREES,
                 "pct_match": round(fine.pct_match, 4),
                 "train_seconds": round(t_fine, 1)},
        "layered_pct_match_unseen": round(acc, 4),
        "k1_plain_mismatches": mism,
        "streaming": dict(
            comp_stats,
            coarse_layer="per-use streaming (zlib blocks decoded on the "
                         "host, compressed node state)",
            fine_layer=("per-use streaming (B3D_V2_STREAM_FINE=1)"
                        if os.environ.get("B3D_V2_STREAM_FINE")
                        else "resident on the device, from the zlib blocks"),
        ),
        "max_rss_gb": round(rss_gb(), 2),
    }
    if old_session:
        summary["bz3d_session_r2"] = old_session
    with open(os.path.join(OUT, "RESULTS.json"), "w") as f:
        json.dump(summary, f, indent=1)
    return summary


def main(argv=None, device=None, intrin=None, log=print):
    """The five steps on the card (``device``: another device; ``intrin``:
    another camera than the D415 at 848x480).  Returns the summary."""
    argv = sys.argv[1:] if argv is None else list(argv)
    device = resolve_device(device)
    n_train = int(argv[0]) if len(argv) > 0 else 120
    n_test = int(argv[1]) if len(argv) > 1 else 16
    intrin = intrin or CameraIntrinsics.d415()
    os.makedirs(OUT, exist_ok=True)

    ds_cfg, _ = step_datagen(intrin, n_train, n_test, device=device, log=log)
    train_data, test_data = load_split(n_train, n_test)
    comp_train = CompressedDataset(train_data)
    comp_stats = compression_stats(comp_train)
    log(f"[stream] dataset compression: {comp_stats}")
    coarse, t_coarse = step_coarse(train_data, test_data, device=device,
                                   log=log)
    fine, t_fine = step_fine(comp_train, test_data, device=device, log=log)
    model = step_assemble(coarse, fine, ds_cfg, device=device)
    lab_k1, mism, acc = step_heldout(model, test_data, log=log)
    summary = step_write(test_data, lab_k1, mism, acc, ds_cfg, comp_stats,
                         coarse, t_coarse, fine, t_fine)
    log(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
