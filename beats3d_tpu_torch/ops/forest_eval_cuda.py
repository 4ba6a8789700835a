"""Forest evaluation kernels of csrc/forest_eval.cu:

* K1, :func:`evaluate_layered_cuda`: every layer of a layered forest plus the
  conditions composite, the counterpart of
  beats3d_tpu/ops/forest_eval_pallas.py:evaluate_layered_pallas;
* B1, :func:`evaluate_forest_cuda`: one forest, with an optional filter
  image, probe scale and single-tree semantics, the counterpart of
  beats3d_tpu/ops/forest_eval_pallas.py:evaluate_forest_pallas;
* B1's pdf-sum mode, :func:`forest_pdf_sum_cuda`: the per-pixel class sums
  of one forest (a tree shard of one, in :mod:`..parallel.eval_sharded`),
  the counterpart of beats3d_tpu/ops/forest_eval.py:forest_pdf_sum.

Each wrapper launches its CUDA kernel for CUDA tensors and runs its plain
version (:mod:`.forest_eval`) for CPU tensors.  There is no fallback from one
to the other.
"""

from __future__ import annotations

import torch

from ..models.forest import PackedForest, forest_dims
from . import cuda_lib, forest_eval

# The kernels' grid holds at most 65,535 blocks of 8 label rows in y.
MAX_LABEL_ROWS = 65535 * 8
# A tree's 2**D - 1 node rows are indexed in 32 bits.
MAX_LEVELS = 30


def _check_grid(what, h, r):
    if h // r > MAX_LABEL_ROWS:
        raise ValueError(
            f"{what}: {h // r} label rows; the grid holds at most "
            f"{MAX_LABEL_ROWS}")


def _check_levels(what, levels):
    if levels > MAX_LEVELS:
        raise ValueError(
            f"{what}: a tree of {levels} levels; the kernel indexes its "
            f"2**D - 1 rows in 32 bits (D <= {MAX_LEVELS})")


def task_pixels(layers, lanes: int = 0) -> int:
    """Label pixels per warp task of K1 at ``lanes`` lanes a pixel; 0: one
    lane per tree of the largest layer, at most 16 (the kernel starts from
    that, and on a card halves it where the lanes would fill the card more
    than 8 times over)."""
    if not lanes:
        most = max(l.forest.num_trees for l in layers)
        lanes = 1
        while lanes < most and lanes < 16:
            lanes *= 2
    return 32 // lanes


def evaluate_layered_plain(depth, layers, conditions, *, labels_reduce: int,
                           scale_factor: float = 1.0, counts=None,
                           lanes: int = 0):
    """The kernel's plain version, on any device; ``counts`` receives the
    routing counts (``forest_eval.routing_counts``) at ``lanes`` lanes a
    pixel (:func:`task_pixels`)."""
    return forest_eval.run_layered(
        depth, tuple(l.forest.tables() for l in layers), conditions,
        filter_specs=tuple((l.filter_model, l.filter_model_class)
                           for l in layers),
        labels_reduce=labels_reduce, scale_factor=scale_factor,
        counts=counts, pixels_per_task=task_pixels(layers, lanes),
    )


class LayerDescs:
    """K1's layer descriptors for one model on one card: ``host``, the
    ctypes array of ``cuda_lib.LayerDesc`` the C entry plans from, and
    ``dev``, the same bytes in device memory, which the kernel reads."""

    def __init__(self, host, device):
        self.host = host
        self.device = device
        # from pinned memory, so the copy makes no host sync (a frame
        # graph's warm-up may build them); the pinned bytes live as long
        self._pinned = torch.frombuffer(bytearray(bytes(host)),
                                        dtype=torch.uint8).pin_memory()
        self.dev = self._pinned.to(device, non_blocking=True)

    def __len__(self):
        return len(self.host)


def layer_descs(layers, device):
    """The kernel's layer descriptors (:class:`LayerDescs`) for ``layers``,
    whose repacked tables must lie on ``device``.  Build it once per model
    (``LayeredDecisionForest.from_numpy`` keeps it on a CUDA model): it
    copies the descriptors to the card."""
    if not len(layers):
        raise ValueError("evaluate_layered_cuda: a model needs a layer")
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
        _check_levels("evaluate_layered_cuda", l.forest.max_depth)
        descs[i] = cuda_lib.LayerDesc(
            l.header.data_ptr(), l.pdf.data_ptr(), l.forest.num_trees,
            l.forest.max_depth, l.forest.num_classes, fm,
            0 if l.filter_model_class is None else int(l.filter_model_class),
        )
    return LayerDescs(descs, device)


def _spill(ints, device):
    """The kernels' per-pixel scratch in device memory, where a block's
    shared memory cannot hold it (``ints`` int2 entries; none when 0)."""
    return (torch.empty(2 * ints, dtype=torch.int32, device=device)
            if ints else None)


def _ptr(t):
    return None if t is None else t.data_ptr()


def evaluate_layered_cuda(depth, layers, conditions, *, labels_reduce: int,
                          scale_factor: float = 1.0, descs=None,
                          lanes: int = 0, counts=None):
    """All layers + the composite over the stride-r label grid.

    depth: (N, H, W); layers: sequence of ``models.layered.LayerSpec``
    (repacked ``header``/``pdf`` tables for the kernel, per-level
    ``forest`` tables for the plain version, filter); conditions: (K, 2)
    int32, or (K, 3) for a routed model (rows that name the layer the
    composite continues at).  Returns (N, H//r, W//r) composite labels,
    65535 = unlabelled.  On CUDA: depth must be contiguous int32, the
    tables and conditions on the same card; returns int32.  ``descs``:
    ``layer_descs(layers)``, built here when not given.  ``lanes``: lanes
    per pixel, 0 to let the kernel choose from the model and the input
    size (as the pipeline does); the others (1, 2, 4, 8, 16) let the card
    tests hold every lane grouping to the plain version.  ``counts``: a
    routed model's (layers, 3) int64 routing counters on the depth's
    device (``RoutingCounts.acc``), which the launch adds to; a two-column
    table takes none.
    A routed table runs the general kernel's routed instantiation, never
    the parameter kernel.  On the CPU: the plain version, in the depth's
    dtype.
    """
    if depth.device.type != "cuda":
        return evaluate_layered_plain(
            depth, layers, conditions, labels_reduce=labels_reduce,
            scale_factor=scale_factor,
            counts=counts if conditions.shape[1] == 3 else None, lanes=lanes)
    if depth.dtype != torch.int32 or not depth.is_contiguous() or depth.dim() != 3:
        raise ValueError(
            f"evaluate_layered_cuda: depth must be contiguous (N, H, W) int32, "
            f"got {depth.dtype} {tuple(depth.shape)}")
    if (conditions.device != depth.device or conditions.dtype != torch.int32
            or not conditions.is_contiguous() or conditions.dim() != 2
            or conditions.shape[1] not in (2, 3) or conditions.shape[0] < 1):
        raise ValueError(
            "evaluate_layered_cuda: conditions must be a contiguous (K, 2) "
            "or (K, 3) int32 tensor of K >= 1 rows on the depth's device")
    routed = conditions.shape[1] == 3
    shape = (len(layers), 3)
    if routed and (counts is None or counts.device != depth.device
                   or counts.dtype != torch.int64
                   or tuple(counts.shape) != shape
                   or not counts.is_contiguous()):
        raise ValueError(
            f"evaluate_layered_cuda: counts must be a contiguous {shape} "
            f"int64 tensor on the depth's device")
    if descs is None:
        descs = layer_descs(layers, depth.device)
    elif descs.device != depth.device or len(descs) != len(layers):
        raise ValueError("evaluate_layered_cuda: descs were built for other "
                         "layers or another device")
    if lanes not in (0, 1, 2, 4, 8, 16):
        raise ValueError(f"evaluate_layered_cuda: lanes {lanes}")
    n, h, w = depth.shape
    r = int(labels_reduce)
    _check_grid("evaluate_layered_cuda", h, r)
    out = torch.empty((n, h // r, w // r), dtype=torch.int32,
                      device=depth.device)
    lib = cuda_lib.library()
    spill = _spill(lib.b3d_layered_spill(n, h, w, r, descs.host, len(descs),
                                         int(lanes)), depth.device)
    args = (depth.data_ptr(), out.data_ptr(), n, h, w, r, float(scale_factor),
            descs.host, descs.dev.data_ptr(), len(descs),
            conditions.data_ptr(), conditions.shape[0], int(lanes),
            _ptr(spill))
    with torch.cuda.device(depth.device):
        stream = torch.cuda.current_stream().cuda_stream
        if routed:
            status = lib.b3d_evaluate_layered_routed(
                *args, counts.data_ptr(), stream)
        else:
            status = lib.b3d_evaluate_layered(*args, stream)
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


def _check_forest(depth, forest, what):
    """B1's checks of a CUDA depth batch and dense forest; returns the
    forest's (trees, levels, classes)."""
    if depth.dtype != torch.int32 or not depth.is_contiguous() or depth.dim() != 3:
        raise ValueError(
            f"{what}: depth must be contiguous (N, H, W) int32, "
            f"got {depth.dtype} {tuple(depth.shape)}")
    if (forest.device != depth.device or forest.dtype != torch.float32
            or not forest.is_contiguous() or forest.dim() != 3):
        raise ValueError(
            f"{what}: the forest must be a contiguous "
            "(T, 2**D - 1, 7 + 2C) float32 tensor on the depth's device")
    trees, levels, classes = forest_dims(forest.shape)
    if trees < 1:
        raise ValueError(f"{what}: the forest has no tree")
    _check_levels(what, levels)
    return trees, levels, classes


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
    contiguous int32, the forest contiguous float32 (any T and C), the
    filter contiguous int32, all on one card; returns int32.
    On the CPU: the plain version, in the depth's dtype.
    """
    kw = dict(labels_reduce=labels_reduce, filter_images=filter_images,
              filter_class=filter_class, scale_factor=scale_factor,
              write_all_eligible=write_all_eligible)
    if depth.device.type != "cuda":
        return evaluate_forest_plain(depth, forest, **kw)
    trees, levels, classes = _check_forest(depth, forest, "evaluate_forest_cuda")
    n, h, w = depth.shape
    r = int(labels_reduce)
    _check_grid("evaluate_forest_cuda", h, r)
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
    spill = _spill(lib.b3d_forest_spill(n, h, w, r, trees, classes, 0, 0),
                   depth.device)
    with torch.cuda.device(depth.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.b3d_evaluate_forest(
            depth.data_ptr(), out.data_ptr(), n, h, w, r, float(scale_factor),
            forest.data_ptr(), trees, levels, classes, _ptr(filter_images),
            int(filter_class), int(bool(write_all_eligible)), 0, _ptr(spill),
            stream,
        )
    cuda_lib.check(status, "evaluate_forest_cuda")
    evaluate_forest_cuda.launches += 1
    return out


# Kernel launches so far (the CPU path does not count).
evaluate_forest_cuda.launches = 0


def forest_pdf_sum_cuda(depth, forest, *, labels_reduce: int = 1,
                        scale_factor: float = 1.0):
    """Per-pixel leaf-pdf sums of one forest on the stride-r grid:
    ((N, H//r, W//r, C) float32, eligible (N, H//r, W//r) bool, all_done
    (N, H//r, W//r) bool), as :func:`.forest_eval.forest_pdf_sum`.

    depth: (N, H, W); forest: dense (T, 2**D - 1, 7 + 2C) float32.  On
    CUDA (depth contiguous int32, the forest contiguous float32 of any T
    and C, on one card) B1 in its pdf-sum mode: the sums are
    the plain version's bit for bit on eligible pixels; an ineligible pixel
    is not walked, its sums are 0 and its all_done True (the plain version
    walks it; ``labels_from_pdf`` never reads it).  On the CPU: the plain
    version.
    """
    if depth.device.type != "cuda":
        return forest_eval.forest_pdf_sum(
            depth, PackedForest.from_flat(forest).tables(),
            labels_reduce=labels_reduce, scale_factor=scale_factor)
    trees, levels, classes = _check_forest(depth, forest, "forest_pdf_sum_cuda")
    n, h, w = depth.shape
    r = int(labels_reduce)
    _check_grid("forest_pdf_sum_cuda", h, r)
    shape = (n, h // r, w // r)
    pdf = torch.empty(shape + (classes,), dtype=torch.float32,
                      device=depth.device)
    eligible = torch.empty(shape, dtype=torch.uint8, device=depth.device)
    all_done = torch.empty(shape, dtype=torch.uint8, device=depth.device)
    lib = cuda_lib.library()
    spill = _spill(lib.b3d_forest_spill(n, h, w, r, trees, classes, 1, 0),
                   depth.device)
    with torch.cuda.device(depth.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.b3d_forest_pdf_sum(
            depth.data_ptr(), pdf.data_ptr(), eligible.data_ptr(),
            all_done.data_ptr(), n, h, w, r, float(scale_factor),
            forest.data_ptr(), trees, levels, classes, _ptr(spill), stream,
        )
    cuda_lib.check(status, "forest_pdf_sum_cuda")
    forest_pdf_sum_cuda.launches += 1
    return pdf, eligible.view(torch.bool), all_done.view(torch.bool)


# Kernel launches so far (the CPU path does not count).
forest_pdf_sum_cuda.launches = 0
