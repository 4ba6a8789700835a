"""Costs of the candidate serving primitives: the port of
scripts/prim_bench.py (P9), kernel ``b3d_probe_prim`` in
csrc/probe_gather.cu.

    python -m beats3d_tpu_torch.probes.prim_bench

Ops on (NT, 8, 128) tiles, tile t reading plane block t % 4 of the
(4, 80, 128) plane:

* shuf_dep / shuf_indep: dependent lane shuffles of ``acc & 127``, or the
  k shuffles of the sources x + i added up;
* roll_indep: the sublane rolls of x + i by 1 + i % 7 added up;
* scratch_rt: the row mins through the scratch, scalar [0, 0] added;
* serve_trip_S (S in 1, 2, 4, 8): k trips of the batched sweep of 8 probes
  serving S cells each (prim_bench.py:68-127).  The reference raises while
  it traces: ``plane`` is a loaded value, and its line 103 slices it with
  ``pl.ds``.  What it means is fully determined, and this port reads it so:
  the window is rows ``[q_al, q_al + 24)`` of the tile's plane block;
* onehot: for each k the (128, 512) one-hot of the first 512 values of
  ``x & 127`` (plus k), summed over its rows; the sums of columns 0..127 are
  added to every row.  The kernel counts for each k; it does not use the
  closed form;
* mm_f32 / mm_f32_hi / mm_bf16 raise ValueError before any launch: the
  reference's operands contradict each other (prim_bench.py:132 takes 128
  rows of an 80-row plane block, so its product is (8, 128) x (80, 128)),
  and there is no computation to port.
"""

from __future__ import annotations

import sys

import torch

from . import tiles
from .tiles import LANE, SUB

SCRIPT = "prim_bench"
NTILE = 256
PLANE_ROWS = 64
NPROBE = 8
BIG = 1 << 29
SERVE = ("serve_trip_1", "serve_trip_2", "serve_trip_4", "serve_trip_8")
OPS = ("shuf_dep", "shuf_indep", "roll_indep", "scratch_rt", "onehot") + SERVE
REFUSED = ("mm_f32", "mm_f32_hi", "mm_bf16")
CASES = tuple(
    tiles.Case(op, (("op", op),), ks, NTILE, refused=op in REFUSED)
    for op, ks in (("shuf_dep", (8, 40)), ("shuf_indep", (8, 40)),
                   ("roll_indep", (8, 40)), ("scratch_rt", (2, 10)),
                   ("serve_trip_1", (3, 12)), ("serve_trip_2", (3, 12)),
                   ("serve_trip_4", (3, 12)), ("serve_trip_8", (3, 12)),
                   ("mm_f32", (2, 10)), ("mm_f32_hi", (2, 10)),
                   ("mm_bf16", (2, 10)), ("onehot", (2, 10))))


def _check_op(op):
    if op in REFUSED:
        raise ValueError(
            f"prim_bench {op}: scripts/prim_bench.py:132 takes 128 rows "
            f"(p_ref[0][0:{LANE}, :]) of a {PLANE_ROWS + 2 * SUB}-row plane "
            f"block, so the product is ({SUB}, {LANE}) x "
            f"({PLANE_ROWS + 2 * SUB}, {LANE}); the operand shapes contradict "
            "each other and there is no computation to port")
    tiles.check_choice("prim_bench op", op, OPS)


def _serve_trip(x, idx, plane, s_cells, k):
    nt = x.shape[0]
    dev = x.device
    blocks = plane[torch.arange(nt, device=dev) % plane.shape[0]]  # (NT, 80, 128)
    rows8 = torch.arange(SUB, device=dev)
    rems = [torch.remainder(x + 131 * p, 997) for p in range(NPROBE)]
    accs = [torch.zeros_like(x) for _ in range(NPROBE)]
    ms = [tiles.tile_min(r) for r in rems]                  # (NT, 1, 1) each
    for _ in range(k):
        new_rems = []
        for p in range(NPROBE):
            m = ms[p]
            q = torch.clamp(torch.div(m, 4, rounding_mode="floor"), 0,
                            PLANE_ROWS - 24)
            q_al = torch.div(q, SUB, rounding_mode="floor") * SUB
            rem = rems[p]
            for d in range(s_cells):
                # row i of roll(roll(window, -(q - q_al)), 24 - d)[0:8]
                rows = q_al[:, :, 0] + torch.remainder(
                    rows8 + d + (q - q_al)[:, :, 0], 3 * SUB)       # (NT, 8)
                win = torch.gather(
                    blocks, 1, rows[:, :, None].expand(nt, SUB, LANE).long())
                v = tiles.lane_gather(win, idx)
                hit = (rem == m + d) & (m < BIG)
                accs[p] = torch.where(hit, v, accs[p])
                rem = torch.where(hit, BIG, rem)
            new_rems.append(rem + 1)
        rems = new_rems
        ms = [tiles.tile_min(r) for r in rems]
    acc = x
    for a in accs:
        acc = acc + a
    return acc


def run_plain(x, idx, plane, *, op, k):
    """The plain PyTorch version: x, idx (NT, 8, 128), plane (4, 80, 128)
    int32."""
    _check_op(op)
    acc = x
    if op == "shuf_dep":
        for _ in range(k):
            acc = tiles.lane_gather(acc & 127, idx)
    elif op == "shuf_indep":
        for i in range(k):
            acc = acc + tiles.lane_gather(x + i, idx)
    elif op == "roll_indep":
        for i in range(k):
            acc = acc + torch.roll(x + i, 1 + i % 7, dims=-2)
    elif op == "scratch_rt":
        for _ in range(k):
            row = acc.amin(dim=-1, keepdim=True)                    # (NT, 8, 1)
            acc = acc + row[:, 0:1]
    elif op == "onehot":
        nt = x.shape[0]
        flat = acc.reshape(nt, 1, SUB * LANE) & 127
        ii = torch.arange(LANE, device=x.device, dtype=torch.int32)[None, :, None]
        for i in range(k):
            oh = ((flat[:, :, 0:SUB * LANE // 2] + i) == ii).to(torch.float32)
            acc = acc + oh.sum(dim=1, keepdim=True).to(torch.int32)[:, :, 0:LANE]
    else:
        acc = _serve_trip(x, idx, plane, int(op.rsplit("_", 1)[1]), k)
    return acc


def run(x, idx, plane, *, op, k):
    """prim_bench.run: the kernel for CUDA tensors, the plain version for CPU
    tensors.  x, idx: (NT, 8, 128) int32, idx in [0, 128); plane:
    (4, 80, 128) int32."""
    if x.device.type != "cuda":
        return run_plain(x, idx, plane, op=op, k=k)
    _check_op(op)
    tiles.check_tensor("prim_bench x", x, (None, SUB, LANE), x.device)
    tiles.check_tensor("prim_bench idx", idx, tuple(x.shape), x.device)
    tiles.check_tensor("prim_bench plane", plane,
                       (4, PLANE_ROWS + 2 * SUB, LANE), x.device)
    out = tiles.launch("b3d_probe_prim", "prim_bench.run", (x, idx, plane),
                       (x.shape[0], OPS.index(op), k), torch.empty_like(x))
    run.launches += 1
    return out


run.launches = 0   # kernel launches so far (the CPU path does not count)
KERNELS = (run,)


def inputs(device):
    a = tiles.on(device, tiles.inputs(SCRIPT))
    return a["x"], a["idx"], a["plane"]


def call(args, case, k, plain=False):
    return (run_plain if plain else run)(*args, **dict(case.kw), k=k)


def main():
    tiles.main(sys.modules[__name__])


if __name__ == "__main__":
    main()
