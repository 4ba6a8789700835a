"""Forest-training driver (counterpart of beats3d_tpu/train/driver.py): train
candidate trees, keep the best N by held-out pixel accuracy, assemble the
forest (reference src/train_model.py)."""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from ..models.forest import DecisionForest, DecisionTree
from ..ops.forest_eval_cuda import evaluate_forest_cuda
from .trainer import DecisionTreeTrainer


def pct_match(pred_labels: np.ndarray, true_labels: np.ndarray) -> float:
    """Matching pixels / labeled pixels."""
    return float(
        np.sum(pred_labels == true_labels) / np.sum(true_labels > 0)
    )


def evaluate_tree_accuracy(tree_or_forest_flat: np.ndarray, test_depth,
                           test_labels, chunk: int = 2, device="cuda"):
    """pct_match of one tree (single-tree semantics: a pixel whose walk does
    not end in a leaf stays unlabelled) or of a forest on the test images,
    through kernel B1 on a card and its plain version on the CPU, ``chunk``
    images at a time (the plain evaluator's lane state grows with the
    batch)."""
    flat = tree_or_forest_flat
    single = flat.ndim == 2
    if single:
        flat = flat[None]
    forest = torch.as_tensor(np.ascontiguousarray(flat, dtype=np.float32),
                             device=device)
    match = labeled = 0
    for lo in range(0, test_depth.shape[0], chunk):
        d = torch.as_tensor(test_depth[lo : lo + chunk].astype(np.int32),
                            device=device)
        pred = evaluate_forest_cuda(d, forest, write_all_eligible=not single)
        pred = pred.cpu().numpy()
        truth = test_labels[lo : lo + chunk]
        match += int(np.sum(pred == truth))
        labeled += int(np.sum(truth > 0))
    if labeled == 0:
        return float("nan")  # no labeled pixels in the test set
    return match / labeled


def train_forest(
    train_data,
    test_data,
    *,
    num_random_features: int,
    proposals_per_block: int,
    images_per_block: Optional[int] = None,
    max_tree_depth: int,
    trees_in_forest: int,
    trees_to_try: Optional[int] = None,
    rng: Optional[np.random.Generator] = None,
    log=print,
    streaming: bool = False,
    checkpoint_dir: Optional[str] = None,
    device="cuda",
) -> DecisionForest:
    """Train ``trees_to_try`` candidate trees on ``device``, keep the
    ``trees_in_forest`` best by held-out pct_match, return the forest.

    ``streaming`` ships image blocks host to device per use.
    ``checkpoint_dir`` makes a run resumable per candidate tree: after each
    tree the forest so far, the acceptance scores and the rng state go to
    ``forest_ckpt.npz`` there, and a rerun with the same config picks up
    after the last completed tree with the rng stream intact (the same
    forest as an uninterrupted run)."""
    rng = rng or np.random.default_rng()
    trees_to_try = trees_to_try or trees_in_forest
    images_per_block = images_per_block or train_data.num_images

    trainer = DecisionTreeTrainer(
        images_per_block, proposals_per_block, streaming=streaming,
        device=device)
    trainer.allocate(train_data, num_random_features, max_tree_depth)

    c = train_data.num_classes()
    tree = DecisionTree(max_tree_depth, c)

    test_depth = test_data.get_depth_block(0)
    test_labels = test_data.get_labels_block(0)

    best: list = [None] * trees_in_forest
    forest = DecisionForest(trees_in_forest, max_tree_depth, c)

    start = 0
    ckpt = (
        os.path.join(checkpoint_dir, "forest_ckpt.npz")
        if checkpoint_dir else None
    )
    if ckpt and os.path.exists(ckpt):
        z = np.load(ckpt, allow_pickle=True)
        if (
            int(z["depth"]) == max_tree_depth
            and int(z["ntry"]) == trees_to_try
            and z["forest"].shape == forest.data.shape
        ):
            start = int(z["done"])
            forest.data[:] = z["forest"]
            best = [
                None if not np.isfinite(b) else float(b) for b in z["best"]
            ]
            rng.bit_generator.state = z["rng_state"].item()
            log(f"[ckpt] resuming after candidate tree {start}"
                f"/{trees_to_try}")
        else:
            log("[ckpt] config mismatch; starting fresh")

    for i in range(start, trees_to_try):
        log(f"training candidate tree {i + 1}/{trees_to_try}")
        trainer.train(train_data, tree, rng)
        acc = evaluate_tree_accuracy(tree.data, test_depth, test_labels,
                                     device=device)
        log(f"  pct. matching pixels: {acc:.4f}")

        copy_idx = -1
        if None in best:
            copy_idx = best.index(None)
        else:
            worst = min(best)
            if acc > worst:
                copy_idx = best.index(worst)
        if copy_idx > -1:
            log(f"  accepted tree at slot {copy_idx}")
            best[copy_idx] = acc
            forest.data[copy_idx] = tree.data.copy()
        if ckpt:
            os.makedirs(checkpoint_dir, exist_ok=True)
            np.savez(
                ckpt, done=i + 1, depth=max_tree_depth,
                ntry=trees_to_try, forest=forest.data,
                best=np.array(
                    [np.nan if b is None else b for b in best], np.float64
                ),
                rng_state=np.array(rng.bit_generator.state, dtype=object),
            )
    if ckpt and os.path.exists(ckpt):
        os.remove(ckpt)  # a finished run must not seed the next fresh one

    acc = evaluate_tree_accuracy(forest.data, test_depth, test_labels,
                                 device=device)
    log(f"FOREST pct. matching pixels: {acc:.4f}")
    forest.pct_match = acc
    return forest
