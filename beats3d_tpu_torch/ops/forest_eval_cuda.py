"""Layered forest evaluation + conditions composite (kernel K1,
csrc/forest_eval.cu), the counterpart of
beats3d_tpu/ops/forest_eval_pallas.py:evaluate_layered_pallas.

:func:`evaluate_layered_cuda` launches the CUDA kernel for CUDA tensors and
runs its plain version, :func:`.forest_eval.run_layered`, for CPU tensors.
There is no fallback from one to the other.
"""

from __future__ import annotations

import torch

from . import cuda_lib, forest_eval

MAX_LAYERS = 4
MAX_CLASSES = 16
MAX_CONDITIONS = 128


def kernel_supports(layers, conditions) -> bool:
    """Whether the kernel takes this model: at most 4 layers of at most 16
    classes each, and a conditions table of at most 128 rows."""
    return (
        1 <= len(layers) <= MAX_LAYERS
        and all(1 <= l.forest.num_classes <= MAX_CLASSES for l in layers)
        and 1 <= conditions.shape[0] <= MAX_CONDITIONS
    )


def evaluate_layered_plain(depth, layers, conditions, *, labels_reduce: int,
                           scale_factor: float = 1.0):
    """The kernel's plain version, on any device."""
    return forest_eval.run_layered(
        depth, tuple(l.forest.tables() for l in layers), conditions,
        filter_specs=tuple((l.filter_model, l.filter_model_class)
                           for l in layers),
        labels_reduce=labels_reduce, scale_factor=scale_factor,
    )


def evaluate_layered_cuda(depth, layers, conditions, *, labels_reduce: int,
                          scale_factor: float = 1.0):
    """All layers + the composite over the stride-r label grid.

    depth: (N, H, W); layers: sequence of ``models.layered.LayerSpec``
    (dense ``flat`` forest, per-level ``forest`` tables, filter);
    conditions: (K, 2) int32.  Returns (N, H//r, W//r) composite labels,
    65535 = unlabelled.  On CUDA: depth must be contiguous int32, the
    forests and conditions contiguous on the same card; returns int32.  On
    the CPU: the plain version, in the depth's dtype.
    """
    if depth.device.type != "cuda":
        return evaluate_layered_plain(
            depth, layers, conditions, labels_reduce=labels_reduce,
            scale_factor=scale_factor)
    if depth.dtype != torch.int32 or not depth.is_contiguous() or depth.dim() != 3:
        raise ValueError(
            f"evaluate_layered_cuda: depth must be contiguous (N, H, W) int32, "
            f"got {depth.dtype} {tuple(depth.shape)}")
    if not kernel_supports(layers, conditions):
        raise ValueError(
            f"evaluate_layered_cuda: the kernel takes <= {MAX_LAYERS} layers, "
            f"<= {MAX_CLASSES} classes and <= {MAX_CONDITIONS} conditions")
    if (conditions.device != depth.device or conditions.dtype != torch.int32
            or not conditions.is_contiguous()):
        raise ValueError(
            "evaluate_layered_cuda: conditions must be contiguous int32 on "
            "the depth's device")
    descs = (cuda_lib.LayerDesc * len(layers))()
    for i, l in enumerate(layers):
        if (l.flat.device != depth.device or l.flat.dtype != torch.float32
                or not l.flat.is_contiguous()):
            raise ValueError(
                f"evaluate_layered_cuda: layer {i}'s forest must be a "
                f"contiguous float32 tensor on the depth's device")
        fm = -1 if l.filter_model is None else int(l.filter_model)
        if fm >= i:
            raise ValueError(
                f"evaluate_layered_cuda: layer {i} filters on layer {fm}")
        descs[i] = cuda_lib.LayerDesc(
            l.flat.data_ptr(), l.forest.num_trees, l.forest.max_depth,
            l.forest.num_classes, fm,
            0 if l.filter_model_class is None else int(l.filter_model_class),
        )
    n, h, w = depth.shape
    r = int(labels_reduce)
    out = torch.empty((n, h // r, w // r), dtype=torch.int32,
                      device=depth.device)
    lib = cuda_lib.library()
    with torch.cuda.device(depth.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.b3d_evaluate_layered(
            depth.data_ptr(), out.data_ptr(), n, h, w, r, float(scale_factor),
            descs, len(layers), conditions.data_ptr(), conditions.shape[0],
            stream,
        )
    cuda_lib.check(status, "evaluate_layered_cuda")
    evaluate_layered_cuda.launches += 1
    return out


# Kernel launches so far (the CPU path does not count).
evaluate_layered_cuda.launches = 0
