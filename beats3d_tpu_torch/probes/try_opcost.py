"""Per-op cost of kernel atoms on (8, 128) tiles: the port of
scripts/try_opcost.py (P11), kernel ``b3d_probe_opcost`` in
csrc/probe_tile.cu.

    python -m beats3d_tpu_torch.probes.try_opcost

Each op is chained k times on every tile: gather (lane gather of
``acc & 127``, dependent), gather_same (the same lane gather of x added k
times), where, fmath (``floor((1.5 * a) / (f + 3))`` in float32), any,
minmax (tile min + max added, wrapping), roll (sublane roll by 1) and
bcast_row (row 0 added to every row, wrapping).
"""

from __future__ import annotations

import sys

import torch

from . import tiles
from .tiles import LANE, SUB

SCRIPT = "try_opcost"
OPS = ("gather", "gather_same", "where", "fmath", "any", "minmax", "roll",
       "bcast_row")
NTILE = 64
CASES = tuple(tiles.Case(op, (("op", op),), (8, 264), NTILE) for op in OPS)


def run_plain(x, idx, *, op, k):
    """The plain PyTorch version: x, idx (NT, 8, 128) int32."""
    tiles.check_choice("try_opcost op", op, OPS)
    acc = x
    if op == "gather":
        for _ in range(k):
            acc = tiles.lane_gather(acc & 127, idx)
    elif op == "gather_same":
        for _ in range(k):
            acc = acc + tiles.lane_gather(x, idx)
    elif op == "where":
        m = x > 5
        for _ in range(k):
            acc = torch.where(m, acc + 1, acc)
    elif op == "fmath":
        f = x.to(torch.float32) + 2.0
        a = f
        for _ in range(k):
            a = torch.floor(1.5 * a / (f + 3.0))
        acc = a.to(torch.int32)
    elif op == "any":
        for _ in range(k):
            acc = acc + tiles.tile_max((acc > 0).to(torch.int32))
    elif op == "minmax":
        for _ in range(k):
            acc = acc + (tiles.tile_min(acc) + tiles.tile_max(acc))
    elif op == "roll":
        for _ in range(k):
            acc = torch.roll(acc, 1, dims=-2)
    else:  # bcast_row
        for _ in range(k):
            acc = acc + acc[:, 0:1]
    return acc


def run(x, idx, *, op, k):
    """try_opcost.run: the kernel for CUDA tensors, the plain version for
    CPU tensors.  x, idx: (NT, 8, 128) int32, idx in [0, 128)."""
    if x.device.type != "cuda":
        return run_plain(x, idx, op=op, k=k)
    tiles.check_choice("try_opcost op", op, OPS)
    tiles.check_tensor("try_opcost x", x, (None, SUB, LANE), x.device)
    tiles.check_tensor("try_opcost idx", idx, tuple(x.shape), x.device)
    out = tiles.launch("b3d_probe_opcost", "try_opcost.run", (x, idx),
                       (x.shape[0], OPS.index(op), k), torch.empty_like(x))
    run.launches += 1
    return out


run.launches = 0   # kernel launches so far (the CPU path does not count)
KERNELS = (run,)


def inputs(device):
    a = tiles.on(device, tiles.inputs(SCRIPT))
    return a["x"], a["idx"]


def call(args, case, k, plain=False):
    return (run_plain if plain else run)(*args, **dict(case.kw), k=k)


def main():
    tiles.main(sys.modules[__name__])


if __name__ == "__main__":
    main()
