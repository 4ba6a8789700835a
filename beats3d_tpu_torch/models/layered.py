"""Layered (stacked/conditional) decision forests, Keskin-style (counterpart of
beats3d_tpu/models/layered.py).

Config JSON schema is the reference's: ``layers`` is a list of ``{"model":
<relative .npy path>, "filter_model": <index of earlier layer>,
"filter_model_class": <class id>}`` (filter keys optional), plus a
``conditions`` table of ``(0, CLASS_ID) | (1, NEXT_OFFSET)`` rows and
``label_colors`` (RGBA per final class).  Model paths are resolved relative
to the config file.

A routed model (Keskin et al.'s local expert network, ECCV 2012: a router
layer sends each pixel to one of several sibling expert layers) adds rows
``(1, NEXT_OFFSET, LAYER)``: the composite continues at layer ``LAYER``
(-1: the next one) with offset ``NEXT_OFFSET``.  A table with such a row
loads as (K, 3), its two-column rows taking -1; a table of two-column rows
loads as (K, 2), as the reference's.  Every row a walk can reach must name
a later layer than the one that reads it, so a walk takes at most one step
a layer.

The reference tests ``'filter_model_class' in l`` as a truthy string, so its
effective rule is "use the filter whenever 'filter_model' is present"; that
effective rule is implemented here, with 'filter_model_class' required
alongside 'filter_model'.

The model's tensors live on one explicit ``device``.  Evaluation follows it:
the CUDA kernel for a CUDA model, the plain evaluator for a CPU model.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops import forest_eval_cuda
from ..utils.profiler import RoutingCounts
from .forest import DecisionForest, PackedForest, kernel_tables


def condition_table(rows) -> np.ndarray:
    """The conditions of a model file as int32: (K, 2) where every row has
    two entries, else (K, 3), a two-column row's layer -1 (the next)."""
    if isinstance(rows, np.ndarray):
        if rows.ndim == 2 and rows.shape[0] and rows.shape[1] in (2, 3):
            return rows.astype(np.int32)
        rows = rows.tolist()
    rows = [list(r) for r in rows]
    widths = {len(r) for r in rows}
    if not rows or not widths <= {2, 3}:
        raise ValueError(f"conditions: rows of 2 or 3 entries, got widths "
                         f"{sorted(widths)}")
    if widths == {2}:
        return np.array(rows, dtype=np.int32)
    return np.array([r + [-1] * (3 - len(r)) for r in rows], dtype=np.int32)


def check_conditions(conditions: np.ndarray, layer_classes: Sequence[int]):
    """Raise ValueError where a condition row that the composite can read
    (walking from layer 0 at offset 0 over every label a layer can give,
    1 .. classes - 1) names a layer that is not later than the one reading
    it, or none of the model's."""
    k = conditions.shape[0]
    num_layers = len(layer_classes)
    seen, todo = set(), [(0, 0)]
    while todo:
        layer, offset = todo.pop()
        if (layer, offset) in seen:
            continue
        seen.add((layer, offset))
        for label in range(1, layer_classes[layer]):
            row = min(max(offset + label - 1, 0), k - 1)
            flag, val = int(conditions[row, 0]), int(conditions[row, 1])
            named = int(conditions[row, 2]) if conditions.shape[1] == 3 else -1
            if flag == 0:
                continue
            nxt = named if flag == 1 and named >= 0 else layer + 1
            if named < -1 or (flag == 1 and named >= 0 and
                              not layer < named < num_layers):
                raise ValueError(
                    f"conditions row {row} ({conditions[row].tolist()}), "
                    f"read at layer {layer}, must name a later layer of the "
                    f"model's {num_layers}")
            if nxt < num_layers:
                todo.append((nxt, val if flag == 1 else offset))


@dataclasses.dataclass
class LayerSpec:
    flat: torch.Tensor          # (T, 2**D - 1, 7 + 2C) float32, dense
    forest: PackedForest        # per-level tables, the plain evaluator's
    filter_model: Optional[int]
    filter_model_class: Optional[int]
    header: torch.Tensor        # (T, 2**D - 1, 8) float32 node headers and
    pdf: torch.Tensor           # (T, 2**D - 1, 2, C) leaf pdfs: the kernel's


@dataclasses.dataclass
class LayeredDecisionForest:
    """Runs the layers' forests in sequence (a filtered layer evaluates only
    the pixels an earlier layer labelled with its class), then composites
    the per-layer label images into final class ids."""

    layers: List[LayerSpec]
    conditions: torch.Tensor    # (K, 2) int32, or (K, 3) routed, on ``device``
    conditions_np: np.ndarray
    label_colors: np.ndarray    # (num_layered_classes, 4) uint8
    num_layered_classes: int
    device: torch.device
    labels_reduce: int = 1
    # a routed model's counters (utils.profiler.counters), else None
    counts: Optional[RoutingCounts] = dataclasses.field(
        default=None, repr=False, compare=False)
    # the kernel's layer descriptors, built at from_numpy for a CUDA model
    kernel_descs: object = dataclasses.field(default=None, repr=False,
                                             compare=False)

    @staticmethod
    def load(config_path: str, labels_reduce: int = 1, device="cuda",
             layer_files=None) -> "LayeredDecisionForest":
        """The model of ``config_path`` on ``device``; ``layer_files``
        ({layer index: path}) reads those layers' forests from other files
        (the flagship's serving variant: ``{1: "m1_serving.npy.gz"}``),
        relative paths resolved as the config's own."""
        with open(config_path) as f:
            cfg = json.load(f)
        root = os.path.dirname(os.path.abspath(config_path))
        layer_files = layer_files or {}
        layers = []
        for i, l in enumerate(cfg["layers"]):
            flat = DecisionForest.load(os.path.join(
                root, layer_files.get(i, l["model"]))).data
            if "filter_model" in l:
                layers.append(
                    (flat, int(l["filter_model"]), int(l["filter_model_class"]))
                )
            else:
                layers.append((flat, None, None))
        return LayeredDecisionForest.from_numpy(
            layers, condition_table(cfg["conditions"]),
            np.array(cfg["label_colors"], dtype=np.uint8), device,
            labels_reduce=labels_reduce,
        )

    @staticmethod
    def from_numpy(layers: Sequence[Tuple], conditions,
                   label_colors: np.ndarray, device,
                   labels_reduce: int = 1) -> "LayeredDecisionForest":
        """Build from numpy parameters: ``layers`` is a list of
        (flat_forest, filter_model, filter_class), the JAX model's
        ``LayerSpec.flat``, ``.filter_model`` and ``.filter_model_class``;
        ``conditions`` (K, 2) or (K, 3) int32, or rows of 2 or 3 entries;
        ``label_colors`` (classes, 4) uint8.  A routed model's counters
        join ``utils.profiler.counters``.  A CUDA model carries K1's layer
        descriptors (``kernel_descs``), built once here on its tables'
        device (``device`` may carry no index)."""
        device = torch.device(device)
        specs = []
        for flat, fm, fc in layers:
            t = torch.as_tensor(
                np.ascontiguousarray(flat, dtype=np.float32)).to(device)
            specs.append(LayerSpec(
                t, PackedForest.from_flat(t),
                None if fm is None else int(fm),
                None if fc is None else int(fc),
                *kernel_tables(t),
            ))
        conditions = condition_table(conditions)
        check_conditions(conditions, [l.forest.num_classes for l in specs])
        num_layered_classes = int(
            max(c[1] for c in conditions if c[0] == 0)
        )
        label_colors = np.asarray(label_colors, dtype=np.uint8)
        if label_colors.shape != (num_layered_classes, 4):
            raise ValueError(
                f"label_colors shape {label_colors.shape}, want "
                f"({num_layered_classes}, 4)"
            )
        filters = [l.filter_model for l in specs]
        experts = [i for i, f in enumerate(filters)
                   if f is not None and filters.count(f) > 1]
        return LayeredDecisionForest(
            layers=specs,
            conditions=torch.as_tensor(conditions).to(device),
            conditions_np=conditions,
            label_colors=label_colors,
            num_layered_classes=num_layered_classes,
            device=device,
            labels_reduce=labels_reduce,
            counts=None if conditions.shape[1] == 2 else RoutingCounts(
                len(specs), experts, device),
            kernel_descs=forest_eval_cuda.layer_descs(
                specs, specs[0].header.device)
            if device.type == "cuda" else None,
        )

    def filter_specs(self) -> Tuple:
        return tuple(
            (l.filter_model, l.filter_model_class) for l in self.layers
        )

    def run(self, depth: torch.Tensor, scale_factor: float = 1.0):
        """Evaluate all layers on (N, H, W) depth on the model's device;
        returns composite (N, H//r, W//r) labels in the depth's dtype
        (65535 = unlabelled)."""
        return run_layered(depth, self, labels_reduce=self.labels_reduce,
                           scale_factor=scale_factor)


def run_layered(depth, model: LayeredDecisionForest, *, labels_reduce: int,
                scale_factor: float = 1.0):
    """The layered forward pass: the CUDA kernel for CUDA tensors, the plain
    evaluator for CPU tensors (see forest_eval_cuda.evaluate_layered_cuda),
    with the model's own layer descriptors."""
    return forest_eval_cuda.evaluate_layered_cuda(
        depth, model.layers, model.conditions,
        labels_reduce=labels_reduce, scale_factor=scale_factor,
        descs=model.kernel_descs,
        counts=None if model.counts is None else model.counts.acc,
    )
