"""Sublane gather against its 8-way select emulation and the lane gather:
the port of scripts/try_axis0.py (P4), kernel ``b3d_probe_axis0`` in
csrc/probe_gather.cu.

    python -m beats3d_tpu_torch.probes.try_axis0

With i8 = idx % 8, each rep adds to acc (zeros) a gather of x + rep:
axis0 ``take_along_axis(., i8, axis=0)`` (the register array indexed at
run time on the card), emul8 the same through 8 compare-selects, axis1
``take_along_axis(., i8, axis=1)`` (shared memory on the card).  The grid
is the script's fixed NT = 64 tiles.
"""

from __future__ import annotations

import sys

import torch

from . import tiles
from .tiles import LANE, SUB

SCRIPT = "try_axis0"
MODES = ("axis0", "emul8", "axis1")
NT = 64
CASES = tuple(tiles.Case(m, (("mode", m),), (2, 34), NT)
              for m in ("emul8", "axis0", "axis1"))


def run_plain(x, idx, *, mode, reps):
    """The plain PyTorch version: x, idx (64, 8, 128) int32."""
    tiles.check_choice("try_axis0 mode", mode, MODES)
    tiles.check_tensor("try_axis0 x", x, (NT, SUB, LANE))
    tiles.check_tensor("try_axis0 idx", idx, (NT, SUB, LANE))
    i8 = idx % SUB
    acc = torch.zeros_like(x)
    for rep in range(reps):
        xv = x + rep
        if mode == "axis0":
            acc = acc + tiles.sublane_gather(xv, i8)
        elif mode == "emul8":
            v = torch.zeros_like(x)
            for r in range(SUB):
                v = torch.where(i8 == r, xv[:, r:r + 1], v)
            acc = acc + v
        else:
            acc = acc + tiles.lane_gather(xv, i8)
    return acc


def run(x, idx, *, mode, reps):
    """try_axis0.run: the kernel for CUDA tensors, the plain version for CPU
    tensors.  x, idx: (64, 8, 128) int32."""
    if x.device.type != "cuda":
        return run_plain(x, idx, mode=mode, reps=reps)
    tiles.check_choice("try_axis0 mode", mode, MODES)
    tiles.check_tensor("try_axis0 x", x, (NT, SUB, LANE), x.device)
    tiles.check_tensor("try_axis0 idx", idx, (NT, SUB, LANE), x.device)
    out = tiles.launch("b3d_probe_axis0", "try_axis0.run", (x, idx),
                       (NT, MODES.index(mode), reps), torch.empty_like(x))
    run.launches += 1
    return out


run.launches = 0   # kernel launches so far (the CPU path does not count)
KERNELS = (run,)


def inputs(device):
    a = tiles.on(device, tiles.inputs(SCRIPT))
    return a["x"], a["idx"]


def call(args, case, k, plain=False):
    return (run_plain if plain else run)(*args, **dict(case.kw), reps=k)


def main():
    tiles.main(sys.modules[__name__])


if __name__ == "__main__":
    main()
