"""Ranks for the multi-device paths: where JAX drives several devices from
one process, the port runs one process per mesh cell.

* :func:`spawn` starts ``world`` ranks with ``torch.multiprocessing`` (the
  ``spawn`` start method), meeting at a ``file://`` rendezvous in a fresh
  temporary directory (no TCP port to clash with a neighbour's), runs
  ``fn(device, *args)`` in each and returns every rank's result.  A rank
  that raises makes :func:`spawn` raise with that rank's traceback; there
  are no partial results.
* :func:`init_from_env` joins a group that ``torchrun`` set up (``RANK``,
  ``WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT`` in the environment).

The backend follows the device, never the other way round: ``nccl`` when
every rank has a card of its own, ``gloo`` when ranks share one card (each
launching its kernels there) or run on the CPU.  ``fn`` must be importable
by name (a module-level function of this package): a spawned rank imports
it afresh.
"""

from __future__ import annotations

import datetime
import os
import pickle
import shutil
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

TIMEOUT = datetime.timedelta(seconds=900)


def backend_for(device, world: int) -> str:
    """``nccl`` when ``world`` ranks on ``device`` each get a card of their
    own, else ``gloo``."""
    device = torch.device(device)
    if device.type == "cuda" and world <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def rank_device(device, rank: int, world: int) -> torch.device:
    """The device rank ``rank`` of ``world`` runs on: the CPU, its own card
    (``nccl``), or the one card the ranks share (``gloo``)."""
    device = torch.device(device)
    if device.type != "cuda":
        return torch.device("cpu")
    if backend_for(device, world) == "nccl":
        return torch.device("cuda", rank)
    return torch.device("cuda", device.index or 0)


def init_rank(rank: int, world: int, device, init_method: str) -> torch.device:
    """Join the default process group as ``rank``; returns its device."""
    dev = rank_device(device, rank, world)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    else:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    dist.init_process_group(backend_for(device, world), init_method=init_method,
                            rank=rank, world_size=world, timeout=TIMEOUT)
    return dev


def init_from_env(device) -> torch.device:
    """Join the group ``torchrun`` describes in the environment; returns
    this rank's device."""
    return init_rank(int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]),
                     device, "env://")


def under_torchrun() -> bool:
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def _rank_main(rank, fn, world, device, init_method, out_dir, args):
    dev = init_rank(rank, world, device, init_method)
    result = fn(dev, *args)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)
    # only on success: a rank that raised exits at once, and spawn then
    # stops the others, which may be waiting in a collective
    dist.destroy_process_group()


def spawn(fn, world: int, *, device, args=()):
    """Run ``fn(rank_device, *args)`` on ``world`` new ranks of one process
    group; returns the list of their results in rank order.

    ``device``: "cuda" or "cpu".  On a card the kernels are built here
    first, so the ranks load the library instead of each running ``nvcc``.
    """
    if torch.device(device).type == "cuda":
        from ..ops import cuda_lib

        cuda_lib.library()
    out_dir = tempfile.mkdtemp(prefix="b3d_ranks_")
    try:
        mp.spawn(_rank_main, nprocs=world, join=True,
                 args=(fn, world, device, f"file://{out_dir}/rdv", out_dir,
                       tuple(args)))
        results = []
        for rank in range(world):
            with open(os.path.join(out_dir, f"rank{rank}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
