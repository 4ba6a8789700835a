"""Randomized-decision-forest artifacts and the per-level tables of the plain
evaluator (counterpart of beats3d_tpu/models/forest.py).

Artifact contract, byte-compatible with the reference's saved models:

    forest = float32 array of shape (num_trees, 2**max_depth - 1, 7 + 2*num_classes)

Each node packs (ux, uy, vx, vy, thresh, l_next, r_next, l_pdf[C], r_pdf[C]).
A child flag whose floor is -1 means "descend to the child at the next level";
any other value ends the walk on that side with its pdf.  Node indices are
within-level: the children of node ``g`` at level ``j`` are ``2g`` and
``2g + 1`` at level ``j + 1``, and node ``g`` of level ``j`` is row
``2**j - 1 + g``.

The single-forest and training kernels walk this dense layout directly.
The layered kernel reads it repacked once at model load
(:func:`kernel_tables`): 32-byte node headers and a separate leaf-pdf table.
The plain evaluator (:mod:`..ops.forest_eval`) advances every pixel one
level per step and reads per-level tables (:class:`PackedForest`).
"""

from __future__ import annotations

import dataclasses
import gzip
import io
import os
from typing import List, Optional

import numpy as np
import torch

HEADER_ELS = 8       # (ux, uy, vx, vy, thresh, l_next, r_next, 0): 32 bytes


def forest_config(max_depth: int, num_classes: int):
    """(total_nodes, max_leaf_nodes, node_els) of a packed tree."""
    return (2 ** max_depth) - 1, 2 ** max_depth, 7 + 2 * num_classes


def forest_dims(shape):
    """(num_trees, max_depth, num_classes) of a packed forest's shape."""
    num_trees, total, els = shape
    max_depth = int(np.log2(total + 1))
    if total != 2 ** max_depth - 1 or (els - 7) % 2 or els < 9:
        raise ValueError(f"not a packed forest shape: {tuple(shape)}")
    return num_trees, max_depth, (els - 7) // 2


def kernel_tables(flat: torch.Tensor):
    """The layered kernel's repacking of a dense (T, 2**D - 1, 7 + 2C)
    float32 forest, on its device: ``header`` (T, 2**D - 1, 8) float32, each
    node's (ux, uy, vx, vy, thresh, l_next, r_next, 0) as 32 aligned bytes
    (two 16-byte loads), and ``pdf`` (T, 2**D - 1, 2, C) float32, the
    (left, right) leaf pdfs, read only at a leaf.  The values are copied
    unchanged (flags are floored in the kernel, as in the dense walk)."""
    t, d, c = forest_dims(flat.shape)
    header = torch.zeros((t, 2 ** d - 1, HEADER_ELS), dtype=torch.float32,
                         device=flat.device)
    header[..., :7] = flat[..., :7]
    pdf = flat[..., 7:].reshape(t, 2 ** d - 1, 2, c).contiguous()
    return header, pdf


@dataclasses.dataclass
class DecisionTree:
    """One tree in packed layout (host numpy), shape (total_nodes, 7 + 2C),
    level order: node g of level j is row 2**j - 1 + g."""

    max_depth: int
    num_classes: int
    data: np.ndarray = None

    def __post_init__(self):
        total, _, els = forest_config(self.max_depth, self.num_classes)
        if self.data is None:
            self.data = np.zeros((total, els), dtype=np.float32)
        assert self.data.shape == (total, els), self.data.shape

    @property
    def total_nodes(self) -> int:
        return self.data.shape[0]


@dataclasses.dataclass
class DecisionForest:
    """A forest in packed layout (host numpy), shape (T, total_nodes, 7+2C).
    ``pct_match`` is the held-out accuracy the trainer measured, if any."""

    num_trees: int
    max_depth: int
    num_classes: int
    data: np.ndarray = None
    pct_match: Optional[float] = None

    def __post_init__(self):
        total, _, els = forest_config(self.max_depth, self.num_classes)
        if self.data is None:
            self.data = np.zeros((self.num_trees, total, els),
                                 dtype=np.float32)
        assert self.data.shape == (self.num_trees, total, els), self.data.shape

    @staticmethod
    def load(path: str) -> "DecisionForest":
        """Load a .npy forest, inferring its dims from the array shape.  A
        forest kept gzipped beside the config (``path + ".gz"``, as the
        committed flagship's fine layer is) is read when ``path`` is
        absent."""
        if not os.path.exists(path) and os.path.exists(path + ".gz"):
            with gzip.open(path + ".gz", "rb") as f:
                arr = np.load(io.BytesIO(f.read()))
        else:
            arr = np.load(path)
        arr = arr.astype(np.float32)
        return DecisionForest(*forest_dims(arr.shape), arr)

    def save(self, path: str) -> None:
        """The reference .npy layout, byte for byte what the JAX package's
        ``DecisionForest.save`` writes."""
        np.save(path, self.data)

    @staticmethod
    def from_trees(trees: List[DecisionTree]) -> "DecisionForest":
        t0 = trees[0]
        data = np.stack([t.data for t in trees]).astype(np.float32)
        return DecisionForest(len(trees), t0.max_depth, t0.num_classes, data)

    def pack(self, device="cpu") -> "PackedForest":
        """Per-level tables of this forest on ``device``."""
        return PackedForest.from_flat(torch.as_tensor(self.data, device=device))


@dataclasses.dataclass
class ForestLevel:
    """Per-level tables (T = num_trees, G = 2**level, C = num_classes):

      uv:      (T, G, 4) float32 — (ux, uy, vx, vy) probe offsets
      thresh:  (T, G)    float32
      lr_next: (T, G, 2) int32   — floor of the stored flags; -1 = descend
      pdf:     (T, G, 2, C) float32 — (left, right) leaf pdfs
    """

    uv: torch.Tensor
    thresh: torch.Tensor
    lr_next: torch.Tensor
    pdf: torch.Tensor


@dataclasses.dataclass
class PackedForest:
    """Per-level tables of one forest, on one device."""

    num_trees: int
    max_depth: int
    num_classes: int
    levels: List[ForestLevel]

    @staticmethod
    def from_flat(flat: torch.Tensor) -> "PackedForest":
        """Split a dense (T, 2**D - 1, 7 + 2C) float32 tensor into levels."""
        t, d, c = forest_dims(flat.shape)
        levels = []
        for j in range(d):
            nodes = flat[:, 2 ** j - 1 : 2 ** (j + 1) - 1, :]
            levels.append(ForestLevel(
                uv=nodes[:, :, 0:4].contiguous(),
                thresh=nodes[:, :, 4].contiguous(),
                lr_next=torch.floor(nodes[:, :, 5:7]).to(torch.int32),
                pdf=torch.stack(
                    [nodes[:, :, 7 : 7 + c], nodes[:, :, 7 + c : 7 + 2 * c]],
                    dim=2,
                ).contiguous(),
            ))
        return PackedForest(t, d, c, levels)

    def tables(self):
        """Per-level (uv, thresh, lr_next, pdf) tuples."""
        return tuple(
            (lv.uv, lv.thresh, lv.lr_next, lv.pdf) for lv in self.levels
        )
