"""Sublane gathers on one (8, 128) or (16, 128) block: the port of
scripts/try_vgather.py, kernels ``b3d_probe_vgather_run`` (P6, the body of
the script's run), ``b3d_probe_vgather8`` (P7, k_vgather) and
``b3d_probe_vgather16`` (P8, k_vgather16) in csrc/probe_gather.cu.

    python -m beats3d_tpu_torch.probes.try_vgather

:func:`run` chains ``o += gather(x, idx ^ (o % 2))`` reps times: v8 along
axis 0, roll as 8 roll candidates of x and a select (candidate k2 is
``roll(x, (8 - k2) % 8, 0)``), h along axis 1.  The script's k_rolls (its
line 32) is reached by no pallas_call; its pattern, roll candidates and a
select, is the roll mode.  The script's run returns ns per op; this run
returns the kernel's output, and :func:`main` prints the times.  Indices
are in [0, 8) (k_vgather16: [0, 16)); the gathers read them & 7 (h: & 127).
"""

from __future__ import annotations

import sys

import torch

from . import tiles
from .tiles import LANE, SUB

SCRIPT = "try_vgather"
MODES = ("v8", "roll", "h")
REPS = 64
CASES = tuple(tiles.Case(m, (("kernel", m),), (REPS,), REPS, checks=(1, 2))
              for m in MODES) + (
    tiles.Case("k_vgather", (("kernel", "k_vgather"),), (1,), 1),
    tiles.Case("k_vgather16", (("kernel", "k_vgather16"),), (1,), 1),
)


def run_plain(kernel, x, idx, reps):
    """The plain PyTorch version: x, idx (8, 128) int32."""
    tiles.check_choice("try_vgather kernel", kernel, MODES)
    o = torch.zeros_like(x)
    for _ in range(reps):
        iv = idx ^ (o % 2)
        if kernel == "v8":
            o = o + tiles.sublane_gather(x, iv)
        elif kernel == "roll":
            acc = torch.zeros_like(x)
            for k2 in range(SUB):
                cand = torch.roll(x, (SUB - k2) % SUB, dims=0)
                acc = torch.where(iv == k2, cand, acc)
            o = o + acc
        else:
            o = o + tiles.lane_gather(x, iv)
    return o


def run(kernel, x, idx, reps):
    """The kernel of try_vgather.run for CUDA tensors, the plain version for
    CPU tensors.  x, idx: (8, 128) int32."""
    if x.device.type != "cuda":
        return run_plain(kernel, x, idx, reps)
    tiles.check_choice("try_vgather kernel", kernel, MODES)
    tiles.check_tensor("try_vgather x", x, (SUB, LANE), x.device)
    tiles.check_tensor("try_vgather idx", idx, (SUB, LANE), x.device)
    out = tiles.launch("b3d_probe_vgather_run", "try_vgather.run", (x, idx),
                       (MODES.index(kernel), reps), torch.empty_like(x))
    run.launches += 1
    return out


def k_vgather_plain(x, idx):
    return tiles.sublane_gather(x, idx)


def k_vgather(x, idx):
    """take_along_axis(x, idx, axis=0): x, idx (8, 128) int32."""
    if x.device.type != "cuda":
        return k_vgather_plain(x, idx)
    tiles.check_tensor("k_vgather x", x, (SUB, LANE), x.device)
    tiles.check_tensor("k_vgather idx", idx, (SUB, LANE), x.device)
    out = tiles.launch("b3d_probe_vgather8", "k_vgather", (x, idx), (),
                       torch.empty_like(idx))
    k_vgather.launches += 1
    return out


def k_vgather16_plain(x, idx):
    i8 = idx % SUB
    lo = tiles.sublane_gather(x[0:SUB], i8)
    hi = tiles.sublane_gather(x[SUB:], i8)
    return torch.where(idx < SUB, lo, hi)


def k_vgather16(x, idx):
    """out[s, l] = x[idx[s, l], l]: x (16, 128), idx (8, 128) int32."""
    if x.device.type != "cuda":
        return k_vgather16_plain(x, idx)
    tiles.check_tensor("k_vgather16 x", x, (2 * SUB, LANE), x.device)
    tiles.check_tensor("k_vgather16 idx", idx, (SUB, LANE), x.device)
    out = tiles.launch("b3d_probe_vgather16", "k_vgather16", (x, idx), (),
                       torch.empty_like(idx))
    k_vgather16.launches += 1
    return out


# kernel launches so far (the CPU path does not count)
run.launches = k_vgather.launches = k_vgather16.launches = 0
KERNELS = (run, k_vgather, k_vgather16)


def inputs(device):
    return tiles.on(device, tiles.inputs(SCRIPT))


def call(args, case, k, plain=False):
    kernel = dict(case.kw)["kernel"]
    if kernel == "k_vgather":
        fn = k_vgather_plain if plain else k_vgather
        return fn(args["x"], args["idx"])
    if kernel == "k_vgather16":
        fn = k_vgather16_plain if plain else k_vgather16
        return fn(args["x16"], args["idx16"])
    return (run_plain if plain else run)(kernel, args["x"], args["idx"], k)


def main():
    tiles.main(sys.modules[__name__])


if __name__ == "__main__":
    main()
