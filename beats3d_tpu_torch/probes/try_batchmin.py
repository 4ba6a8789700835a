"""16 full-tile mins per rep, as separate reduces or batched through a
scratch: the port of scripts/try_batchmin.py (P10), kernel
``b3d_probe_batchmin`` in csrc/probe_tile.cu.

    python -m beats3d_tpu_torch.probes.try_batchmin

With arrs[i] = x + i (i < 8), each rep takes the 16 scalars
min(arrs[i] + rep) and min(arrs[i] + rep + 1) and adds their sum to acc.
base takes each as its own full-tile reduce (one barrier each on the card);
batched takes axis-0 mins, then one axis-1 min of the 16 rows, through the
scratch (shared memory on the card, one barrier).  The grid is the
script's fixed NT = 64 tiles.
"""

from __future__ import annotations

import sys

import torch

from . import tiles
from .tiles import LANE, SUB

SCRIPT = "try_batchmin"
MODES = ("base", "batched")
NT = 64
NPROBE = 8
CASES = tuple(tiles.Case(m, (("mode", m),), (2, 18), NT) for m in MODES)


def run_plain(x, *, mode, reps):
    """The plain PyTorch version: x (64, 8, 128) int32."""
    tiles.check_choice("try_batchmin mode", mode, MODES)
    tiles.check_tensor("try_batchmin x", x, (NT, SUB, LANE))
    acc = x
    arrs = [acc + i for i in range(NPROBE)]
    for rep in range(reps):
        if mode == "base":
            mins = [tiles.tile_min(a + rep) for a in arrs]
            mins += [tiles.tile_min(a + rep + 1) for a in arrs]
        else:
            rows = [(a + rep).amin(dim=1, keepdim=True) for a in arrs]
            rows += [(a + rep + 1).amin(dim=1, keepdim=True) for a in arrs]
            va = torch.cat(rows[:8], dim=1).amin(dim=2, keepdim=True)
            vb = torch.cat(rows[8:], dim=1).amin(dim=2, keepdim=True)
            mins = ([va[:, i:i + 1] for i in range(8)]
                    + [vb[:, i:i + 1] for i in range(8)])
        s = mins[0]
        for m in mins[1:]:
            s = s + m
        acc = acc + s
    return acc


def run(x, *, mode, reps):
    """try_batchmin.run: the kernel for CUDA tensors, the plain version for
    CPU tensors.  x: (64, 8, 128) int32."""
    if x.device.type != "cuda":
        return run_plain(x, mode=mode, reps=reps)
    tiles.check_choice("try_batchmin mode", mode, MODES)
    tiles.check_tensor("try_batchmin x", x, (NT, SUB, LANE), x.device)
    out = tiles.launch("b3d_probe_batchmin", "try_batchmin.run", (x,),
                       (NT, MODES.index(mode), reps), torch.empty_like(x))
    run.launches += 1
    return out


run.launches = 0   # kernel launches so far (the CPU path does not count)
KERNELS = (run,)


def inputs(device):
    return (tiles.on(device, tiles.inputs(SCRIPT))["x"],)


def call(args, case, k, plain=False):
    return (run_plain if plain else run)(*args, **dict(case.kw), reps=k)


def main():
    tiles.main(sys.modules[__name__])


if __name__ == "__main__":
    main()
