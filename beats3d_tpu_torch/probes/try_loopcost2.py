"""Loop cost against the number of carries, division cost, nested 0/1
loops: the port of scripts/try_loopcost2.py (P3), kernel
``b3d_probe_loopcost2`` in csrc/probe_tile.cu.

    python -m beats3d_tpu_torch.probes.try_loopcost2

The carries are x + i, i < n_carries.  noloop adds 1 to each n_loops
times; flat wraps each step in a loop of t = min(max(x) * 0 + 1, 1) trips,
nested in two such loops; div runs ``a = floor((a + 1) / f)`` n_loops
times on a_i = f + i, f = float(x) + 3, i < 4, and the 4 results (truncated
to int32) take the place of the first carries.  Then the carries are
summed.  n_carries is one of 1, 2, 4, 8 or 16: the kernel's carries are a
register array sized at compile time.
"""

from __future__ import annotations

import sys

import torch

from . import tiles
from .tiles import LANE, SUB

SCRIPT = "try_loopcost2"
MODES = ("noloop", "flat", "nested", "div")
CARRIES = (1, 2, 4, 8, 16)
NT = 64
CASES = tuple(
    tiles.Case(f"{m} carries={c}", (("mode", m), ("n_carries", c)), (8, 72), NT)
    for m, c in (("noloop", 8), ("flat", 1), ("flat", 4), ("flat", 8),
                 ("flat", 16), ("nested", 8), ("div", 8)))


def _check(mode, n_carries):
    tiles.check_choice("try_loopcost2 mode", mode, MODES)
    tiles.check_choice("try_loopcost2 n_carries", n_carries, CARRIES)


def run_plain(x, *, mode, n_loops, n_carries):
    """The plain PyTorch version: x (NT, 8, 128) int32."""
    _check(mode, n_carries)
    t = torch.clamp(tiles.tile_max(x) * 0 + 1, max=1)
    trips = torch.clamp(t, min=0)            # fori_loop(0, t) runs max(t, 0)
    carries = [x + i for i in range(n_carries)]
    if mode == "div":
        f = x.to(torch.float32) + 3.0
        a = [f + i for i in range(4)]
        for _ in range(n_loops):
            a = [torch.floor((v + 1.0) / f) for v in a]
        carries = [v.to(torch.int32) for v in a] + carries[4:]
    else:
        step = {"noloop": 1, "flat": trips, "nested": trips * trips}[mode]
        for _ in range(n_loops):
            carries = [c + step for c in carries]
    acc = carries[0]
    for c in carries[1:]:
        acc = acc + c
    return acc


def run(x, *, mode, n_loops, n_carries):
    """try_loopcost2.run: the kernel for CUDA tensors, the plain version
    for CPU tensors.  x: (NT, 8, 128) int32."""
    if x.device.type != "cuda":
        return run_plain(x, mode=mode, n_loops=n_loops, n_carries=n_carries)
    _check(mode, n_carries)
    tiles.check_tensor("try_loopcost2 x", x, (None, SUB, LANE), x.device)
    out = tiles.launch("b3d_probe_loopcost2", "try_loopcost2.run", (x,),
                       (x.shape[0], MODES.index(mode), n_loops, n_carries),
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
