"""The rectangle-serving roll chain on a (24, 128) block: the port of
scripts/repro_roll24.py (P12), kernel ``b3d_probe_roll24`` in
csrc/probe_gather.cu.

    python -m beats3d_tpu_torch.probes.repro_roll24

A dynamic roll by -off (off a (1, 1) int32 tensor, read on the card from
device memory as the TPU reads its SMEM scalar), then a static roll by
24 - d, rows 0..7: ``out[i] = x[(i + off + d) mod 24]``.  The script checks
every d in (0, 1, 2, 3, 7) and off in 0..7; the table times off = 0 and
compares every off.
"""

from __future__ import annotations

import sys

import torch

from . import tiles
from .tiles import LANE, SUB

SCRIPT = "repro_roll24"
NLOAD = 24
DS = (0, 1, 2, 3, 7)
CASES = tuple(tiles.Case(f"d={d}", (("d", d),), (0,), 1,
                         checks=tuple(range(1, SUB))) for d in DS)


def run_plain(x, off, *, d):
    """The plain PyTorch version: x (24, 128), off (1, 1) int32."""
    tiles.check_tensor("repro_roll24 x", x, (NLOAD, LANE))
    tiles.check_tensor("repro_roll24 off", off, (1, 1))
    rows = torch.remainder(
        torch.arange(SUB, device=x.device) + off[0, 0].long() + d, NLOAD)
    return x[rows]


def run(x, off, *, d):
    """repro_roll24.run: the kernel for CUDA tensors, the plain version for
    CPU tensors.  x: (24, 128) int32; off: (1, 1) int32."""
    if x.device.type != "cuda":
        return run_plain(x, off, d=d)
    tiles.check_tensor("repro_roll24 x", x, (NLOAD, LANE), x.device)
    tiles.check_tensor("repro_roll24 off", off, (1, 1), x.device)
    out = tiles.launch("b3d_probe_roll24", "repro_roll24.run", (x, off), (d,),
                       torch.empty((SUB, LANE), dtype=torch.int32,
                                   device=x.device))
    run.launches += 1
    return out


run.launches = 0   # kernel launches so far (the CPU path does not count)
KERNELS = (run,)


def inputs(device):
    x = tiles.on(device, tiles.inputs(SCRIPT))["x"]
    offs = [torch.full((1, 1), off, dtype=torch.int32, device=device)
            for off in range(SUB)]
    return x, offs


def call(args, case, k, plain=False):
    x, offs = args
    return (run_plain if plain else run)(x, offs[k], **dict(case.kw))


def main():
    tiles.main(sys.modules[__name__])


if __name__ == "__main__":
    main()
