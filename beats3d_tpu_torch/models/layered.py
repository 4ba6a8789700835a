"""Layered (stacked/conditional) decision forests, Keskin-style (counterpart of
beats3d_tpu/models/layered.py).

Config JSON schema is the reference's: ``layers`` is a list of ``{"model":
<relative .npy path>, "filter_model": <index of earlier layer>,
"filter_model_class": <class id>}`` (filter keys optional), plus a
``conditions`` table of ``(0, CLASS_ID) | (1, NEXT_OFFSET)`` rows and
``label_colors`` (RGBA per final class).  Model paths are resolved relative
to the config file.

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
from .forest import DecisionForest, PackedForest, kernel_tables


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
    conditions: torch.Tensor    # (K, 2) int32, on ``device``
    conditions_np: np.ndarray
    label_colors: np.ndarray    # (num_layered_classes, 4) uint8
    num_layered_classes: int
    device: torch.device
    labels_reduce: int = 1
    # the kernel's layer descriptors, built at the first CUDA evaluation
    kernel_descs: object = dataclasses.field(default=None, repr=False,
                                             compare=False)

    @staticmethod
    def load(config_path: str, labels_reduce: int = 1,
             device="cuda") -> "LayeredDecisionForest":
        with open(config_path) as f:
            cfg = json.load(f)
        root = os.path.dirname(os.path.abspath(config_path))
        layers = []
        for l in cfg["layers"]:
            flat = DecisionForest.load(os.path.join(root, l["model"])).data
            if "filter_model" in l:
                layers.append(
                    (flat, int(l["filter_model"]), int(l["filter_model_class"]))
                )
            else:
                layers.append((flat, None, None))
        return LayeredDecisionForest.from_numpy(
            layers, np.array(cfg["conditions"], dtype=np.int32),
            np.array(cfg["label_colors"], dtype=np.uint8), device,
            labels_reduce=labels_reduce,
        )

    @staticmethod
    def from_numpy(layers: Sequence[Tuple], conditions: np.ndarray,
                   label_colors: np.ndarray, device,
                   labels_reduce: int = 1) -> "LayeredDecisionForest":
        """Build from numpy parameters: ``layers`` is a list of
        (flat_forest, filter_model, filter_class), the JAX model's
        ``LayerSpec.flat``, ``.filter_model`` and ``.filter_model_class``;
        ``conditions`` (K, 2) int32; ``label_colors`` (classes, 4) uint8."""
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
        conditions = np.asarray(conditions, dtype=np.int32)
        num_layered_classes = int(
            max(c[1] for c in conditions if c[0] == 0)
        )
        label_colors = np.asarray(label_colors, dtype=np.uint8)
        if label_colors.shape != (num_layered_classes, 4):
            raise ValueError(
                f"label_colors shape {label_colors.shape}, want "
                f"({num_layered_classes}, 4)"
            )
        return LayeredDecisionForest(
            layers=specs,
            conditions=torch.as_tensor(conditions).to(device),
            conditions_np=conditions,
            label_colors=label_colors,
            num_layered_classes=num_layered_classes,
            device=device,
            labels_reduce=labels_reduce,
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
    evaluator for CPU tensors (see forest_eval_cuda.evaluate_layered_cuda).
    The kernel's layer descriptors are built once per model."""
    if depth.device.type == "cuda" and model.kernel_descs is None:
        model.kernel_descs = forest_eval_cuda.layer_descs(model.layers,
                                                          depth.device)
    return forest_eval_cuda.evaluate_layered_cuda(
        depth, model.layers, model.conditions,
        labels_reduce=labels_reduce, scale_factor=scale_factor,
        descs=model.kernel_descs,
    )
