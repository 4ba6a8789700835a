"""Plain per-pixel decision-forest evaluation: the benchmark's reference for
the layered forest (kernel K1) and the single forest (kernel B1).

A frozen copy of the port's plain evaluator (beats3d_tpu_torch/ops/
forest_eval.py, models/forest.py and the layered model's loader), which the
port's kernels are held to bit for bit: level-synchronous walks, leaf pdfs
summed level by level in tree order, depth 0 and 65535 missing, probes out
of bounds read 65535, offsets ``floor(scale * u / d)`` with IEEE float32
division, a strictly-greater argmax from (0.0, class 0).

``ftype`` is the type the feature is computed in: float32, as the
configuration states, or a lower precision for the benchmark's control.
Imports nothing of the program.
"""

from __future__ import annotations

import gzip
import io
import json
import os
from typing import List, Optional, Tuple

import numpy as np
import torch

MAX_UINT16 = 65535


def load_flat(path: str) -> np.ndarray:
    """A dense (T, 2**D - 1, 7 + 2C) float32 forest from ``path`` (.npy,
    gzipped .npy, or ``path + ".gz"`` when ``path`` is absent)."""
    if not path.endswith(".gz") and not os.path.exists(path) and \
            os.path.exists(path + ".gz"):
        path += ".gz"
    if path.endswith(".gz"):
        with gzip.open(path, "rb") as f:
            arr = np.load(io.BytesIO(f.read()))
    else:
        arr = np.load(path)
    return arr.astype(np.float32)


def forest_dims(shape):
    """(num_trees, max_depth, num_classes) of a dense forest's shape."""
    num_trees, total, els = shape
    max_depth = int(np.log2(total + 1))
    if total != 2 ** max_depth - 1 or (els - 7) % 2 or els < 9:
        raise ValueError(f"not a dense forest shape: {tuple(shape)}")
    return num_trees, max_depth, (els - 7) // 2


def level_tables(flat: torch.Tensor):
    """Per-level (uv (T, G, 4), thresh (T, G), lr_next (T, G, 2) int32,
    pdf (T, G, 2, C)) tables of a dense forest on its device."""
    t, d, c = forest_dims(flat.shape)
    out = []
    for j in range(d):
        nodes = flat[:, 2 ** j - 1: 2 ** (j + 1) - 1, :]
        out.append((
            nodes[:, :, 0:4].contiguous(),
            nodes[:, :, 4].contiguous(),
            torch.floor(nodes[:, :, 5:7]).to(torch.int32),
            torch.stack([nodes[:, :, 7:7 + c], nodes[:, :, 7 + c:7 + 2 * c]],
                        dim=2).contiguous(),
        ))
    return tuple(out)


class Layered:
    """A layered model as the reference reads it from the artifact files:
    per layer its level tables and (filter layer, filter class), the
    conditions table and the number of final classes."""

    def __init__(self, layers, conditions: np.ndarray, device):
        self.device = torch.device(device)
        self.tables = [level_tables(torch.as_tensor(f).to(self.device))
                       for f, _, _ in layers]
        self.filters = [(fm, fc) for _, fm, fc in layers]
        self.conditions_np = np.asarray(conditions, np.int32)
        self.conditions = torch.as_tensor(self.conditions_np).to(self.device)
        self.num_classes = int(max(c[1] for c in self.conditions_np
                                   if c[0] == 0))

    @staticmethod
    def load(config_path: str, device) -> "Layered":
        """The model of a ``model_cfg.json`` (the reference 3d-beats
        layered-forest config: ``layers`` with ``model`` paths relative to
        it and optional ``filter_model``/``filter_model_class``)."""
        with open(config_path) as f:
            cfg = json.load(f)
        root = os.path.dirname(os.path.abspath(config_path))
        layers = []
        for l in cfg["layers"]:
            flat = load_flat(os.path.join(root, l["model"]))
            if "filter_model" in l:
                layers.append((flat, int(l["filter_model"]),
                               int(l["filter_model_class"])))
            else:
                layers.append((flat, None, None))
        return Layered(layers, np.array(cfg["conditions"], np.int32), device)


def load(config_path: str, device) -> Layered:
    """The layered model of a ``model_cfg.json`` (the contract of
    ``reference.models``)."""
    return Layered.load(config_path, device)


def _probe(depth_flat, yy, xx, h: int, w: int):
    """Depth at integer coords (N, ...) with out-of-bounds -> 65535."""
    inb = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
    lin = yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)
    n = depth_flat.shape[0]
    vals = torch.gather(depth_flat, 1, lin.reshape(n, -1)).reshape(yy.shape)
    return torch.where(inb, vals, MAX_UINT16)


def depth_difference_feature(depth, yd, xd, d_center, u, v,
                             scale_factor: float = 1.0,
                             ftype=torch.float32):
    """Shotton feature f = D(p + u/D(p)) - D(p + v/D(p)) in ``ftype``.

    depth: (N, H, W) int32. yd/xd/d_center: (N, ...) broadcastable lane
    coords and centre depths. u, v: (..., 2) float32 offsets."""
    n, h, w = depth.shape
    depth_flat = depth.reshape(n, h * w)
    df = d_center.to(ftype)
    safe_df = torch.where(df == 0, 1.0, df).to(ftype)
    s = float(scale_factor)

    def off(a):
        # (s * a) / d, each step rounded to ftype, divided by a tensor
        return torch.floor(s * a.to(ftype) / safe_df).to(torch.int32)

    ux, uy = off(u[..., 0]), off(u[..., 1])
    vx, vy = off(v[..., 0]), off(v[..., 1])
    shape = torch.broadcast_shapes(yd.shape, ux.shape)
    du = _probe(depth_flat, (yd + uy).expand(shape), (xd + ux).expand(shape),
                h, w).to(ftype)
    dv = _probe(depth_flat, (yd + vy).expand(shape), (xd + vx).expand(shape),
                h, w).to(ftype)
    return torch.where(df == 0, 0.0, du - dv).to(ftype)


def forest_pdf_sum(depth, tables: Tuple, *, labels_reduce: int = 1,
                   filter_images=None, filter_class: int = -1,
                   scale_factor: float = 1.0, visits: Optional[List] = None,
                   ftype=torch.float32):
    """Walk all trees level by level; return the per-pixel summed leaf pdf,
    the eligibility mask and the all-trees-terminated mask:
    ((N, Hl, Wl, C) float32, (N, Hl, Wl) bool, (N, Hl, Wl) bool).

    ``visits`` receives, per level, the dense-layout rows (tree *
    (2**D - 1) + node row) that eligible pixels read and the leaf sides
    (2 * row + side) at which they stop: what a kernel must read for these
    inputs (the work counts of ``portbench/work``)."""
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
            scale_factor, ftype)
        side = (~(f < th_g.to(ftype))).to(torch.int64)
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
                    write_all_eligible: bool = True, ftype=torch.float32,
                    visits: Optional[List] = None):
    """Labels (N, H//r, W//r) int32 of one forest, 65535 where not
    evaluated; ``visits`` as :func:`forest_pdf_sum`'s."""
    pdf_sum, eligible, all_done = forest_pdf_sum(
        depth, tables, labels_reduce=labels_reduce,
        filter_images=filter_images, filter_class=filter_class,
        scale_factor=scale_factor, visits=visits, ftype=ftype)
    return labels_from_pdf(pdf_sum, eligible, all_done, write_all_eligible)


def composite_labels(label_images, conditions):
    """Per-layer label images (M, N, Hl, Wl) -> final class ids through the
    conditions table (K, 2): row (0, CLASS) emits CLASS, (1, NEXT)
    continues at offset NEXT; 0 or 65535 leaves the pixel at 65535."""
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
    return out.to(torch.int32)


def run_layered(depth, model: Layered, *, labels_reduce: int,
                scale_factor: float = 1.0, visits: Optional[List] = None,
                ftype=torch.float32):
    """Every layer in order (a filtered layer evaluates only the pixels an
    earlier layer labelled with its class), then the composite.  Returns
    (N, H//r, W//r) int32.  ``visits`` receives one list of per-level
    visits per layer."""
    label_images = []
    for tables, (fm, fc) in zip(model.tables, model.filters):
        kw = dict(labels_reduce=labels_reduce, scale_factor=scale_factor,
                  ftype=ftype)
        if fm is not None:
            kw.update(filter_images=label_images[fm], filter_class=int(fc))
        lv = None if visits is None else []
        pdf_sum, eligible, all_done = forest_pdf_sum(depth, tables,
                                                     visits=lv, **kw)
        if visits is not None:
            visits.append(lv)
        label_images.append(labels_from_pdf(pdf_sum, eligible, all_done))
    return composite_labels(torch.stack(label_images), model.conditions)
