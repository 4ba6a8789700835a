"""Per-pixel decision-forest evaluation in plain PyTorch (counterpart of
beats3d_tpu/ops/forest_eval.py).

This is the plain version of the CUDA kernel in :mod:`.forest_eval_cuda`: the
CPU runs it, and the checks on the card hold the kernel against it.  It keeps
the JAX evaluator's execution model so the two agree bit for bit:

* traversal is level-synchronous: every (pixel, tree) lane advances one
  level per step through the per-level tables of ``PackedForest``;
* leaf pdfs are summed level by level, the trees of one level in tree order
  (the kernels sum in the same order);
* depth 0 and 65535 are "missing"; a probe out of bounds reads 65535; a
  centre depth of 0 makes the feature 0; probe offsets are
  ``floor(scale * u / d)`` with IEEE float32 division;
* the argmax starts from (0.0, class 0) and takes a class only when strictly
  greater, which for non-negative pdfs is the first maximum.

Depth is any integer dtype (uint16 as in the JAX package, or the int32 the
pipeline carries); label images come back in the depth's dtype.
"""

from __future__ import annotations

from typing import Tuple

import torch

MAX_UINT16 = 65535


def _probe(depth_flat, yy, xx, h: int, w: int):
    """Depth at integer coords (N, ...) with out-of-bounds -> 65535."""
    inb = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
    lin = yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)
    n = depth_flat.shape[0]
    vals = torch.gather(depth_flat, 1, lin.reshape(n, -1)).reshape(yy.shape)
    return torch.where(inb, vals, MAX_UINT16)


def depth_difference_feature(depth, yd, xd, d_center, u, v,
                             scale_factor: float = 1.0):
    """Shotton feature f = D(p + u/D(p)) - D(p + v/D(p)) as float32.

    depth: (N, H, W) int32. yd/xd/d_center: (N, ...) broadcastable lane
    coords and centre depths. u, v: (..., 2) float32 offsets.
    """
    n, h, w = depth.shape
    depth_flat = depth.reshape(n, h * w)
    df = d_center.to(torch.float32)
    safe_df = torch.where(df == 0, 1.0, df)
    s = float(scale_factor)

    def off(a):
        # (s * a) / d, each step rounded to float32: the divisor is a
        # tensor, so CUDA divides too (it would multiply by a reciprocal
        # for a Python-scalar divisor)
        return torch.floor(s * a / safe_df).to(torch.int32)

    ux, uy = off(u[..., 0]), off(u[..., 1])
    vx, vy = off(v[..., 0]), off(v[..., 1])
    shape = torch.broadcast_shapes(yd.shape, ux.shape)
    du = _probe(depth_flat, (yd + uy).expand(shape), (xd + ux).expand(shape),
                h, w).to(torch.float32)
    dv = _probe(depth_flat, (yd + vy).expand(shape), (xd + vx).expand(shape),
                h, w).to(torch.float32)
    return torch.where(df == 0, 0.0, du - dv)


def forest_pdf_sum(depth, tables: Tuple, *, labels_reduce: int = 1,
                   filter_images=None, filter_class: int = -1,
                   scale_factor: float = 1.0, visits=None):
    """Walk all trees level by level; return the per-pixel summed leaf pdf,
    the eligibility mask and the all-trees-terminated mask:
    ((N, Hl, Wl, C) float32, (N, Hl, Wl) bool, (N, Hl, Wl) bool).

    ``visits``: a list that receives, per level, the dense-layout rows
    (tree * (2**D - 1) + node row) that eligible pixels read and the leaf
    sides (2 * row + side) at which they stop: what a kernel must read for
    these inputs."""
    depth = depth.to(torch.int32)
    n, h, w = depth.shape
    r = labels_reduce
    hl, wl = h // r, w // r
    num_trees = tables[0][0].shape[0]
    num_classes = tables[0][3].shape[-1]
    dev = depth.device

    yd = (torch.arange(hl, dtype=torch.int32, device=dev) * r).view(1, hl, 1, 1)
    xd = (torch.arange(wl, dtype=torch.int32, device=dev) * r).view(1, 1, wl, 1)
    d_center = depth[:, : hl * r : r, : wl * r : r]
    eligible = (d_center != 0) & (d_center != MAX_UINT16)
    if filter_images is not None:
        eligible &= filter_images.to(torch.int32) == filter_class

    lane_shape = (n, hl, wl, num_trees)
    g = torch.zeros(lane_shape, dtype=torch.int64, device=dev)
    done = torch.zeros(lane_shape, dtype=torch.bool, device=dev)
    pdf_sum = torch.zeros((n, hl, wl, num_classes), dtype=torch.float32,
                          device=dev)
    d_center_t = d_center[..., None]
    tree_base = torch.arange(num_trees, dtype=torch.int64, device=dev)
    nodes = 2 ** len(tables) - 1

    for j, (uv, thresh, lr_next, pdf) in enumerate(tables):
        g_level = 1 << j
        gidx = tree_base * g_level + g
        uv_g = uv.reshape(num_trees * g_level, 4)[gidx]
        th_g = thresh.reshape(num_trees * g_level)[gidx]
        f = depth_difference_feature(
            depth, yd, xd, d_center_t, uv_g[..., 0:2], uv_g[..., 2:4],
            scale_factor,
        )
        side = (~(f < th_g)).to(torch.int64)
        slot = gidx * 2 + side
        descend = lr_next.reshape(-1)[slot] == -1
        hit_leaf = (~done) & (~descend)
        pdf_g = pdf.reshape(num_trees * g_level * 2, num_classes)[slot]
        contrib = torch.where(hit_leaf[..., None], pdf_g, 0.0)
        level_sum = contrib[..., 0, :]
        for t in range(1, num_trees):
            level_sum = level_sum + contrib[..., t, :]
        pdf_sum = pdf_sum + level_sum
        if visits is not None:
            live = (~done) & eligible[..., None]
            row = tree_base * nodes + (g_level - 1) + g
            visits.append((row[live], (2 * row + side)[hit_leaf & live]))
        g = torch.where((~done) & descend, 2 * g + side, g)
        done = done | hit_leaf

    return pdf_sum, eligible, done.all(dim=-1)


def labels_from_pdf(pdf_sum, eligible, all_done, write_all_eligible=True):
    """Strictly-greater argmax from (0.0, class 0), masked to eligible
    pixels (and, for single-tree semantics, to fully terminated walks).
    Returns int32 labels, 65535 where not written."""
    best_v = torch.zeros(pdf_sum.shape[:-1], dtype=torch.float32,
                         device=pdf_sum.device)
    best_c = torch.zeros(pdf_sum.shape[:-1], dtype=torch.int32,
                         device=pdf_sum.device)
    for k in range(pdf_sum.shape[-1]):
        better = pdf_sum[..., k] > best_v
        best_v = torch.where(better, pdf_sum[..., k], best_v)
        best_c = torch.where(better, k, best_c)
    write = eligible if write_all_eligible else (eligible & all_done)
    return torch.where(write, best_c, MAX_UINT16)


def evaluate_forest(depth, tables: Tuple, *, labels_reduce: int = 1,
                    filter_images=None, filter_class: int = -1,
                    scale_factor: float = 1.0,
                    write_all_eligible: bool = True):
    """Classify every r-th pixel of (N, H, W) depth images with one forest.
    Returns (N, H//r, W//r) labels in the depth's dtype, 65535 where not
    evaluated."""
    pdf_sum, eligible, all_done = forest_pdf_sum(
        depth, tables, labels_reduce=labels_reduce,
        filter_images=filter_images, filter_class=filter_class,
        scale_factor=scale_factor,
    )
    labels = labels_from_pdf(pdf_sum, eligible, all_done, write_all_eligible)
    return labels.to(depth.dtype)


def evaluate_tree(depth, tables: Tuple):
    """Single-tree semantics: full resolution, no filter, unit scale;
    pixels whose walk does not end in a leaf keep 65535."""
    return evaluate_forest(depth, tables, labels_reduce=1,
                           write_all_eligible=False)


def composite_labels(label_images, conditions):
    """Combine per-layer label images (M, N, Hl, Wl) into final class ids
    through the conditions table (K, 2): per pixel, walk the layers with a
    running offset; row ``conditions[offset + label - 1]`` = (0, CLASS)
    emits CLASS, (1, NEXT) continues at offset NEXT; a label of 0 or 65535
    leaves the pixel unlabelled (65535).  Returns (N, Hl, Wl) in the label
    images' dtype."""
    k = conditions.shape[0]
    cond = conditions.to(torch.int64)
    lab = label_images.to(torch.int64)
    out_shape = lab.shape[1:]
    dev = lab.device
    offset = torch.zeros(out_shape, dtype=torch.int64, device=dev)
    out = torch.full(out_shape, MAX_UINT16, dtype=torch.int64, device=dev)
    done = torch.zeros(out_shape, dtype=torch.bool, device=dev)
    for l in lab:
        invalid = (l == 0) | (l == MAX_UINT16)
        row_idx = (offset + l - 1).clamp(0, k - 1)
        flag = cond[:, 0][row_idx]
        val = cond[:, 1][row_idx]
        active = (~done) & (~invalid)
        emit = active & (flag == 0)
        out = torch.where(emit, val, out)
        offset = torch.where(active & (flag == 1), val, offset)
        done = done | invalid | emit
    return out.to(label_images.dtype)


def layered_visits(depth, layer_tables: Tuple, *, filter_specs: Tuple,
                   labels_reduce: int, scale_factor: float = 1.0):
    """What a layered evaluation must read on these inputs, per layer: a
    dict of ``rows`` (distinct node rows read), ``leaves`` (distinct leaf
    sides reached), ``steps`` (pixel-tree-level steps) and ``leaf_hits``.
    Counts the bound of a kernel, from the plain walk."""
    label_images, out = [], []
    for tables, (fm, fc) in zip(layer_tables, filter_specs):
        kw = dict(labels_reduce=labels_reduce, scale_factor=scale_factor)
        if fm is not None:
            kw.update(filter_images=label_images[fm], filter_class=int(fc))
        visits = []
        pdf_sum, eligible, all_done = forest_pdf_sum(depth, tables,
                                                     visits=visits, **kw)
        label_images.append(labels_from_pdf(pdf_sum, eligible, all_done))
        rows = torch.cat([r for r, _ in visits])
        leaves = torch.cat([l for _, l in visits])
        out.append(dict(rows=int(torch.unique(rows).numel()),
                        leaves=int(torch.unique(leaves).numel()),
                        steps=int(rows.numel()), leaf_hits=int(leaves.numel())))
    return out


def run_layered(depth, layer_tables: Tuple, conditions, *,
                filter_specs: Tuple, labels_reduce: int,
                scale_factor: float = 1.0):
    """Every layer's forest in order (a filtered layer evaluates only the
    pixels an earlier layer labelled ``filter_class``), then the conditions
    composite.  filter_specs: per layer (filter_model | None,
    filter_class | None).  Returns (N, H//r, W//r) in the depth's dtype."""
    label_images = []
    for tables, (fm, fc) in zip(layer_tables, filter_specs):
        kw = dict(labels_reduce=labels_reduce, scale_factor=scale_factor)
        if fm is not None:
            kw.update(filter_images=label_images[fm], filter_class=int(fc))
        label_images.append(evaluate_forest(depth, tables, **kw))
    return composite_labels(torch.stack(label_images), conditions)

