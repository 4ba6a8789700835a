"""Fixed cost of a loop whose trip count comes from data: the port of
scripts/try_loopcost.py (P2), kernel ``b3d_probe_loopcost`` in
csrc/probe_tile.cu.

    python -m beats3d_tpu_torch.probes.try_loopcost

``x + n_loops``: n_loops unrolled +1s (dyn=False), or n_loops loops of
t = min(max(x) * 0 + 1, 1) trips (dyn=True).  The script times
n_loops in {1, 16, 64, 256}; the table differences the first and the last.
"""

from __future__ import annotations

import sys

import torch

from . import tiles
from .tiles import LANE, SUB

SCRIPT = "try_loopcost"
NT = 64
CASES = tuple(tiles.Case(f"dyn={dyn}", (("dyn", dyn),), (1, 16, 64, 256), NT)
              for dyn in (False, True))


def run_plain(x, *, n_loops, dyn):
    """The plain PyTorch version: x (NT, 8, 128) int32."""
    acc = x
    t = torch.clamp(tiles.tile_max(acc) * 0 + 1, max=1)
    for _ in range(n_loops):
        # fori_loop(0, t, +1) adds max(t, 0)
        acc = acc + (torch.clamp(t, min=0) if dyn else 1)
    return acc


def run(x, *, n_loops, dyn):
    """try_loopcost.run: the kernel for CUDA tensors, the plain version for
    CPU tensors.  x: (NT, 8, 128) int32."""
    if x.device.type != "cuda":
        return run_plain(x, n_loops=n_loops, dyn=dyn)
    tiles.check_tensor("try_loopcost x", x, (None, SUB, LANE), x.device)
    out = tiles.launch("b3d_probe_loopcost", "try_loopcost.run", (x,),
                       (x.shape[0], int(bool(dyn)), n_loops),
                       torch.empty_like(x))
    run.launches += 1
    return out


run.launches = 0   # kernel launches so far (the CPU path does not count)
KERNELS = (run,)


def inputs(device):
    return (tiles.on(device, tiles.inputs(SCRIPT))["x"],)


def call(args, case, k, plain=False):
    return (run_plain if plain else run)(*args, **dict(case.kw), n_loops=k)


def main():
    tiles.main(sys.modules[__name__])


if __name__ == "__main__":
    main()
