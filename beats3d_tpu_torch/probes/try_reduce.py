"""Independent against serial tile reduces, and a static against a
data-derived loop bound: the port of scripts/try_reduce.py (P1), kernel
``b3d_probe_reduce`` in csrc/probe_tile.cu.

    python -m beats3d_tpu_torch.probes.try_reduce

Modes: indep_reduce (k tile mins of x + i summed, added to x),
serial_reduce (s = min(x + s), k times), static_loop (k unrolled 4-trip +1
loops), dyn_loop (k 4-trip loops from lo = min(x) * 0), dyn_loop_1red (the
same with lo = min(acc) * 0 before each loop).  The kernel computes the
loop bounds as the script does; nvcc sees that ``min * 0`` is 0.
"""

from __future__ import annotations

import sys

import torch

from . import tiles
from .tiles import LANE, SUB

SCRIPT = "try_reduce"
MODES = ("indep_reduce", "serial_reduce", "static_loop", "dyn_loop",
         "dyn_loop_1red")
NT = 256
CASES = tuple(tiles.Case(m, (("mode", m),), (2, 34), NT) for m in MODES)


def run_plain(x, *, mode, k):
    """The plain PyTorch version: x (NT, 8, 128) int32."""
    tiles.check_choice("try_reduce mode", mode, MODES)
    acc = x
    if mode == "indep_reduce":
        tot = torch.zeros_like(tiles.tile_min(x))
        for i in range(k):
            tot = tot + tiles.tile_min(x + i)
        acc = x + tot
    elif mode == "serial_reduce":
        s = torch.zeros_like(tiles.tile_min(x))
        for _ in range(k):
            s = tiles.tile_min(x + s)
        acc = x + s
    else:
        # every mode runs k loops of 4 trips: lo = min(.) * 0 is 0 for any
        # tile, so the dynamic bounds [lo, lo + 4) hold 4 trips
        for _ in range(k):
            for _ in range(4):
                acc = acc + 1
    return acc


def run(x, *, mode, k):
    """try_reduce.run: the kernel for CUDA tensors, the plain version for
    CPU tensors.  x: (NT, 8, 128) int32."""
    if x.device.type != "cuda":
        return run_plain(x, mode=mode, k=k)
    tiles.check_choice("try_reduce mode", mode, MODES)
    tiles.check_tensor("try_reduce x", x, (None, SUB, LANE), x.device)
    out = tiles.launch("b3d_probe_reduce", "try_reduce.run", (x,),
                       (x.shape[0], MODES.index(mode), k), torch.empty_like(x))
    run.launches += 1
    return out


run.launches = 0   # kernel launches so far (the CPU path does not count)
KERNELS = (run,)


def inputs(device):
    return (tiles.on(device, tiles.inputs(SCRIPT))["x"],)


def call(args, case, k, plain=False):
    return (run_plain if plain else run)(*args, **dict(case.kw), k=k)


def main():
    tiles.main(sys.modules[__name__])


if __name__ == "__main__":
    main()
