"""Forest evaluation kernels of csrc/forest_eval.cu:

* K1, :func:`evaluate_layered_cuda`: every layer of a layered forest plus the
  conditions composite, the counterpart of
  beats3d_tpu/ops/forest_eval_pallas.py:evaluate_layered_pallas;
* B1, :func:`evaluate_forest_cuda`: one forest, with an optional filter
  image, probe scale and single-tree semantics, the counterpart of
  beats3d_tpu/ops/forest_eval_pallas.py:evaluate_forest_pallas.

Each wrapper launches its CUDA kernel for CUDA tensors and runs its plain
version (:mod:`.forest_eval`) for CPU tensors.  There is no fallback from one
to the other.
"""

from __future__ import annotations

import torch

from ..models.forest import PackedForest, forest_dims
from . import cuda_lib, forest_eval

MAX_LAYERS = 4
MAX_CLASSES = 16
MAX_CONDITIONS = 128
MAX_TREES = 16


def kernel_supports(layers, conditions) -> bool:
    """Whether the kernel takes this model: at most 4 layers of at most 16
    trees and 16 classes each, and a conditions table of at most 128 rows."""
    return (
        1 <= len(layers) <= MAX_LAYERS
        and all(1 <= l.forest.num_classes <= MAX_CLASSES
                and 1 <= l.forest.num_trees <= MAX_TREES for l in layers)
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


def layer_descs(layers, device):
    """The kernel's layer descriptors (ctypes array of ``LayerDesc``) for
    ``layers``, whose repacked tables must lie on ``device``.  Build it once
    per model (``models.layered.run_layered`` keeps it on the model)."""
    descs = (cuda_lib.LayerDesc * len(layers))()
    for i, l in enumerate(layers):
        for name, t in (("header", l.header), ("pdf", l.pdf)):
            if (t.device != device or t.dtype != torch.float32
                    or not t.is_contiguous()):
                raise ValueError(
                    f"evaluate_layered_cuda: layer {i}'s {name} table must be "
                    f"a contiguous float32 tensor on {device}")
        fm = -1 if l.filter_model is None else int(l.filter_model)
        if fm >= i:
            raise ValueError(
                f"evaluate_layered_cuda: layer {i} filters on layer {fm}")
        descs[i] = cuda_lib.LayerDesc(
            l.header.data_ptr(), l.pdf.data_ptr(), l.forest.num_trees,
            l.forest.max_depth, l.forest.num_classes, fm,
            0 if l.filter_model_class is None else int(l.filter_model_class),
        )
    descs.device = device
    return descs


def evaluate_layered_cuda(depth, layers, conditions, *, labels_reduce: int,
                          scale_factor: float = 1.0, descs=None,
                          lanes: int = 0):
    """All layers + the composite over the stride-r label grid.

    depth: (N, H, W); layers: sequence of ``models.layered.LayerSpec``
    (repacked ``header``/``pdf`` tables for the kernel, per-level
    ``forest`` tables for the plain version, filter); conditions: (K, 2)
    int32.  Returns (N, H//r, W//r) composite labels, 65535 = unlabelled.
    On CUDA: depth must be contiguous int32, the tables and conditions on
    the same card; returns int32.  ``descs``: ``layer_descs(layers)``, built
    here when not given.  ``lanes``: lanes per pixel, 0 to let the kernel
    choose from the model and the input size (as the pipeline does); the
    others (1, 2, 4, 8, 16) serve the card tests and kernel_bench's sweep.
    On the CPU: the plain version, in the depth's dtype.
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
            f"evaluate_layered_cuda: the kernel takes <= {MAX_LAYERS} layers "
            f"of <= {MAX_TREES} trees and <= {MAX_CLASSES} classes, and <= "
            f"{MAX_CONDITIONS} conditions")
    if (conditions.device != depth.device or conditions.dtype != torch.int32
            or not conditions.is_contiguous()):
        raise ValueError(
            "evaluate_layered_cuda: conditions must be contiguous int32 on "
            "the depth's device")
    if descs is None:
        descs = layer_descs(layers, depth.device)
    elif descs.device != depth.device or len(descs) != len(layers):
        raise ValueError("evaluate_layered_cuda: descs were built for other "
                         "layers or another device")
    if lanes not in (0, 1, 2, 4, 8, 16):
        raise ValueError(f"evaluate_layered_cuda: lanes {lanes}")
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
            int(lanes), stream,
        )
    cuda_lib.check(status, "evaluate_layered_cuda")
    evaluate_layered_cuda.launches += 1
    return out


# Kernel launches so far (the CPU path does not count).
evaluate_layered_cuda.launches = 0


def evaluate_forest_plain(depth, forest, *, labels_reduce: int = 1,
                          filter_images=None, filter_class: int = -1,
                          scale_factor: float = 1.0,
                          write_all_eligible: bool = True):
    """The B1 kernel's plain version, on any device."""
    return forest_eval.evaluate_forest(
        depth, PackedForest.from_flat(forest).tables(),
        labels_reduce=labels_reduce, filter_images=filter_images,
        filter_class=filter_class, scale_factor=scale_factor,
        write_all_eligible=write_all_eligible)


def evaluate_forest_cuda(depth, forest, *, labels_reduce: int = 1,
                         filter_images=None, filter_class: int = -1,
                         scale_factor: float = 1.0,
                         write_all_eligible: bool = True):
    """Labels of one forest on the stride-r grid.

    depth: (N, H, W); forest: dense (T, 2**D - 1, 7 + 2C) float32;
    filter_images: optional (N, H//r, W//r), a pixel is evaluated only where
    it equals ``filter_class``; ``write_all_eligible=False`` writes only the
    pixels where every tree reached a leaf (single-tree semantics).  Returns
    (N, H//r, W//r) labels, 65535 where not written.  On CUDA: depth
    contiguous int32, the forest contiguous float32 with T <= 16 and
    C <= 16, the filter contiguous int32, all on one card; returns int32.
    On the CPU: the plain version, in the depth's dtype.
    """
    kw = dict(labels_reduce=labels_reduce, filter_images=filter_images,
              filter_class=filter_class, scale_factor=scale_factor,
              write_all_eligible=write_all_eligible)
    if depth.device.type != "cuda":
        return evaluate_forest_plain(depth, forest, **kw)
    if depth.dtype != torch.int32 or not depth.is_contiguous() or depth.dim() != 3:
        raise ValueError(
            f"evaluate_forest_cuda: depth must be contiguous (N, H, W) int32, "
            f"got {depth.dtype} {tuple(depth.shape)}")
    if (forest.device != depth.device or forest.dtype != torch.float32
            or not forest.is_contiguous() or forest.dim() != 3):
        raise ValueError(
            "evaluate_forest_cuda: the forest must be a contiguous "
            "(T, 2**D - 1, 7 + 2C) float32 tensor on the depth's device")
    trees, levels, classes = forest_dims(forest.shape)
    if not (1 <= trees <= MAX_TREES and classes <= MAX_CLASSES):
        raise ValueError(
            f"evaluate_forest_cuda: the kernel takes <= {MAX_TREES} trees "
            f"and <= {MAX_CLASSES} classes, got {trees} and {classes}")
    n, h, w = depth.shape
    r = int(labels_reduce)
    out_shape = (n, h // r, w // r)
    if filter_images is not None and (
            filter_images.device != depth.device
            or filter_images.dtype != torch.int32
            or not filter_images.is_contiguous()
            or tuple(filter_images.shape) != out_shape):
        raise ValueError(
            f"evaluate_forest_cuda: filter_images must be a contiguous "
            f"{out_shape} int32 tensor on the depth's device")
    out = torch.empty(out_shape, dtype=torch.int32, device=depth.device)
    lib = cuda_lib.library()
    with torch.cuda.device(depth.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.b3d_evaluate_forest(
            depth.data_ptr(), out.data_ptr(), n, h, w, r, float(scale_factor),
            forest.data_ptr(), trees, levels, classes,
            None if filter_images is None else filter_images.data_ptr(),
            int(filter_class), int(bool(write_all_eligible)), 0, stream,
        )
    cuda_lib.check(status, "evaluate_forest_cuda")
    evaluate_forest_cuda.launches += 1
    return out


# Kernel launches so far (the CPU path does not count).
evaluate_forest_cuda.launches = 0
