"""The work a kernel must do, counted from its inputs, and the card's
published peaks: the yardstick of the roofline and utilization metrics.

Frozen copies of the port's counts (beats3d_tpu_torch/kernel_bench.py:
``k1_work``, ``k2_work``, ``b4_work``, ``bound``), with K1's node visits
taken from the reference's own plain walk (``reference.forest``), so that a
count does not change with the code it measures.  Bytes: each input read
once and each output written once; operations: float32 operations.
"""

from __future__ import annotations

import torch

# NVIDIA H100 SXM, published: HBM3 bandwidth and float32 outside the tensor
# cores, at the full 700 W power limit.
MEM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def bound_s(bytes_moved: float, ops: float):
    """(seconds, "bytes" | "operations"): the least time the card could
    take, the larger of the bytes' and the operations' time at the peaks."""
    t_bytes = bytes_moved / MEM_BYTES_PER_S
    t_ops = ops / F32_OPS_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def walk_counts(visits):
    """One layer's per-level [(rows, leaf sides)] visits -> dict of
    ``rows`` (distinct node rows read), ``leaves`` (distinct leaf sides
    reached), ``steps`` (pixel-tree-level steps), ``leaf_hits``."""
    rows = torch.cat([r for r, _ in visits])
    leaves = torch.cat([l for _, l in visits])
    return dict(rows=int(torch.unique(rows).numel()),
                leaves=int(torch.unique(leaves).numel()),
                steps=int(rows.numel()), leaf_hits=int(leaves.numel()))


def walk_ops(steps: int, leaf_hits: int, classes: int) -> int:
    """Float32 operations of a forest walk (K1's or B1's): 9 per
    pixel-tree-level step (4 multiplies, 4 divisions, 1 subtraction) and
    ``classes`` adds per leaf reached."""
    return 9 * steps + classes * leaf_hits


def k1_work(shape, layer_counts, layer_classes, conditions_rows: int,
            labels_reduce: int):
    """(bytes, operations) of one K1 launch on an (N, H, W) int32 stack:
    the depth read once, the labels written once, the 32-byte header of
    every node row the walk visits and the leaf pdf rows it reaches, the
    conditions; 9 float32 operations per pixel-tree-level step (4
    multiplies, 4 divisions, 1 subtraction) and C adds per leaf reached.
    ``layer_counts``: per layer the :func:`walk_counts` of the reference
    walk's visits."""
    n, h, w = shape
    r = labels_reduce
    bytes_moved = 4 * n * h * w + 4 * n * (h // r) * (w // r)
    bytes_moved += 4 * 2 * conditions_rows
    ops = 0
    for v, c in zip(layer_counts, layer_classes):
        bytes_moved += 32 * v["rows"] + 4 * c * v["leaves"]
        ops += walk_ops(v["steps"], v["leaf_hits"], c)
    return bytes_moved, ops


def k2_work(numel: int):
    """(bytes, operations) of K2 (plane band + gaussian) on ``numel``
    pixels: each read once and written once; 114 float32 operations a
    pixel (the deprojection and plane test, 4 per tap over 25 taps, the
    division and floor)."""
    return 8 * numel, 114 * numel


def b4_work(shape, proposals: int, active_pixels: int):
    """(bytes, operations) of one B4 launch on an (N, H, W) int32 block:
    depth, proposals and the active mask read once, the packed words
    written once; 10 operations per (active pixel, proposal)."""
    n, h, w = shape
    bytes_moved = 4 * n * h * w + 5 * 4 * proposals + n * h * w
    bytes_moved += 4 * n * ((proposals + 31) // 32) * h * w
    return bytes_moved, 10 * active_pixels * proposals
