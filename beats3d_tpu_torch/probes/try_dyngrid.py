"""A grid sized by a count on the device, tile ids from a list: the port of
scripts/try_dyngrid.py (P5), kernel ``b3d_probe_dyngrid`` in
csrc/probe_tile_list.cu.

    python -m beats3d_tpu_torch.probes.try_dyngrid

The first n_active ids of tile_list name tiles of x that become x * 2 + 1;
the others stay as they are.  n_active is a 0-d int32 tensor and is never
read on the host: the kernel launches max_tiles CTAs and those at or past
n_active return.  The result is a new tensor (the JAX call is functional)
and x is left unchanged.  Ids are distinct; ids outside x are skipped.  The
table differences n_active = 4 and 240: ns per listed tile.
"""

from __future__ import annotations

import sys

import torch

from . import tiles
from .tiles import LANE, SUB

SCRIPT = "try_dyngrid"
T = 240
CASES = (tiles.Case("tile_list", (("max_tiles", T),), (4, T), 1),)


def run_plain(x, tile_list, n_active, *, max_tiles):
    """The plain PyTorch version, with no host sync on n_active either."""
    tiles.check_tensor("try_dyngrid x", x, (None, SUB, LANE))
    tiles.check_tensor("try_dyngrid tile_list", tile_list, (None,))
    ids = tile_list[:max_tiles].long()
    listed = ((torch.arange(ids.shape[0], device=x.device) < n_active)
              & (ids >= 0) & (ids < x.shape[0]))
    mark = torch.zeros(x.shape[0], dtype=torch.int32, device=x.device)
    mark.scatter_reduce_(0, ids.clamp(0, x.shape[0] - 1),
                         listed.to(torch.int32), reduce="amax")
    return torch.where(mark[:, None, None] > 0, x * 2 + 1, x)


def run(x, tile_list, n_active, *, max_tiles):
    """try_dyngrid.run: the kernel for CUDA tensors, the plain version for
    CPU tensors.  x: (T, 8, 128) int32; tile_list: (>= max_tiles,) int32;
    n_active: () int32."""
    if x.device.type != "cuda":
        return run_plain(x, tile_list, n_active, max_tiles=max_tiles)
    tiles.check_tensor("try_dyngrid x", x, (None, SUB, LANE), x.device)
    tiles.check_tensor("try_dyngrid tile_list", tile_list, (None,), x.device)
    tiles.check_tensor("try_dyngrid n_active", n_active, (), x.device)
    if not 0 <= max_tiles <= tile_list.shape[0]:
        raise ValueError(f"try_dyngrid: max_tiles {max_tiles} outside "
                         f"[0, {tile_list.shape[0]}]")
    out = tiles.launch("b3d_probe_dyngrid", "try_dyngrid.run",
                       (x, tile_list, n_active), (max_tiles, x.shape[0]),
                       x.clone())
    run.launches += 1
    return out


run.launches = 0   # kernel launches so far (the CPU path does not count)
KERNELS = (run,)


def inputs(device):
    a = tiles.on(device, tiles.inputs(SCRIPT))
    counts = {n: torch.tensor(n, dtype=torch.int32, device=device)
              for n in CASES[0].ks}
    return a["x"], a["tile_list"], counts


def call(args, case, k, plain=False):
    x, tile_list, counts = args
    return (run_plain if plain else run)(x, tile_list, counts[k],
                                         **dict(case.kw))


def main():
    tiles.main(sys.modules[__name__])


if __name__ == "__main__":
    main()
