"""A (data, model) grid of ranks on ``torch.distributed`` (counterpart of
beats3d_tpu/parallel/mesh.py).

JAX lays its devices out as a mesh inside one process; here each grid cell
is a rank, a process of its own (:mod:`.launch` starts them).  The axes
mean what they mean in the JAX package:

* ``data``: pure data parallelism over frames or image rows; training
  histograms are integer counts, so their sum over ``data`` is exact;
* ``model``: trees (tree-sharded evaluation, partial pdf sums summed over
  ``model``) or split proposals (training: each rank scans its slice and
  the best splits are merged).

The backend is ``nccl`` when every rank has a card of its own and ``gloo``
when ranks share a card or run on the CPU (:func:`.launch.backend_for`).
``gloo`` reduces and gathers host tensors, so a collective of CUDA tensors
stages through the host (a copy out, the collective, a copy back): that is
the ``gloo`` path itself, not a fallback; ``nccl`` needs none.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

AXES = ("data", "model")
_OPS = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN,
        "max": dist.ReduceOp.MAX}
# dtypes the backends do not move, and what they travel as
_WIRE = {torch.bool: torch.uint8, torch.uint16: torch.int32}


class Mesh:
    """This rank's view of an (n_data, n_model) grid of ranks.

    ``grid[i, j]`` is the global rank at data index i, model index j
    (row-major, as JAX reshapes its devices); ``shape`` is
    ``{"data": n_data, "model": n_model}``; ``coords`` this rank's
    ``{"data": i, "model": j}`` (None for a rank outside the grid, which
    takes no part in the sharded functions).  ``device`` holds this rank's
    tensors; ``backend`` is the one chosen for the axis groups.
    ``bytes_reduced`` counts the bytes this rank has put into collectives.
    """

    def __init__(self, grid: np.ndarray, device, backend: str):
        self.grid = grid
        self.shape = {"data": int(grid.shape[0]), "model": int(grid.shape[1])}
        self.device = torch.device(device)
        self.backend = backend
        self.rank = dist.get_rank()
        where = np.argwhere(grid == self.rank)
        self.coords = (dict(zip(AXES, (int(v) for v in where[0])))
                       if len(where) else None)
        self.bytes_reduced = 0
        # every rank creates every group, in the same order
        self._groups = {}
        for j in range(grid.shape[1]):
            g = dist.new_group([int(r) for r in grid[:, j]], backend=backend)
            if self.coords and self.coords["model"] == j:
                self._groups["data"] = g
        for i in range(grid.shape[0]):
            g = dist.new_group([int(r) for r in grid[i, :]], backend=backend)
            if self.coords and self.coords["data"] == i:
                self._groups["model"] = g

    def index(self, axis: str) -> int:
        if self.coords is None:
            raise ValueError(f"rank {self.rank} is outside the mesh "
                             f"{self.grid.tolist()}")
        return self.coords[axis]

    def shard(self, x, axis: str):
        """This rank's contiguous slice of ``x`` along its first dimension,
        which must divide by the axis size."""
        n = self.shape[axis]
        if x.shape[0] % n:
            raise ValueError(f"a leading dimension of {x.shape[0]} does not "
                             f"divide over the {n} ranks of '{axis}'")
        step = x.shape[0] // n
        i = self.index(axis)
        return x[i * step:(i + 1) * step]

    def _wire(self, t):
        """The tensor as it travels: on the host for gloo, in a dtype the
        backend moves."""
        t = t.detach()
        if self.backend == "gloo":
            t = t.cpu()
        return t.to(_WIRE.get(t.dtype, t.dtype))

    def all_reduce(self, t, axis: str, op: str = "sum"):
        """``op`` ("sum", "min" or "max") of ``t`` over the ranks of ``axis``
        (JAX's psum, pmin, pmax); returns a new tensor on ``t``'s device."""
        buf = self._wire(t).clone()
        self.bytes_reduced += buf.numel() * buf.element_size()
        dist.all_reduce(buf, op=_OPS[op], group=self._groups[axis])
        return buf.to(device=t.device, dtype=t.dtype)

    def all_gather(self, t, axis: str):
        """``t`` of every rank of ``axis`` concatenated along the first
        dimension in axis order; on ``t``'s device."""
        buf = self._wire(t).contiguous()
        parts = [torch.empty_like(buf) for _ in range(self.shape[axis])]
        self.bytes_reduced += buf.numel() * buf.element_size()
        dist.all_gather(parts, buf, group=self._groups[axis])
        return torch.cat(parts).to(device=t.device, dtype=t.dtype)


def make_mesh(n_data: Optional[int] = None, n_model: int = 1, *,
              device=None) -> Mesh:
    """A (data, model) mesh over the first ``n_data * n_model`` ranks of the
    initialised default process group (all of them on ``data`` by default).

    ``device``: this rank's device; None means its current card.  The axis
    groups take the default group's backend (``launch`` chose it: ``nccl``
    for one card per rank, else ``gloo``).
    Every rank of the default group must call this, in the same order.
    """
    world = dist.get_world_size()
    if n_data is None:
        n_data = world // n_model
    assert n_data * n_model <= world, (n_data, n_model, world)
    if device is None:
        device = torch.device("cuda", torch.cuda.current_device())
    grid = np.arange(n_data * n_model).reshape(n_data, n_model)
    return Mesh(grid, device, dist.get_backend())
