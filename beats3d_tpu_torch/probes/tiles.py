"""The shared layer of the probe ports: the (NT, 8, 128) int32 tile, the
scripts' inputs, the launch of a probe kernel, the tables (timed from a
CUDA graph, ``utils.profiler.graph_ms``) and the scripts' differencing.

A TPU vreg is 8 sublanes x 128 lanes; the scripts/ probes work on int32
tiles of that shape, NT of them along the grid.  A probe's time per unit
is ``(t(k2) - t(k1)) / (k2 - k1) / NT``: two launches that differ only in
the count k, so the launch and the loads cancel.
"""

from __future__ import annotations

import dataclasses
import sys

import numpy as np
import torch

from ..ops import cuda_lib
from ..utils.profiler import graph_ms

SUB, LANE = 8, 128


@dataclasses.dataclass(frozen=True)
class Case:
    """One line of a script's table.

    ``kw`` holds run's static arguments other than the count; ``ks`` the
    counts the script times (two are differenced, one is divided by
    ``per``); ``per`` the divisor of the per-unit time (the script's NT);
    ``checks`` further counts at which kernel and plain version are only
    compared; ``refused`` marks a case whose run raises ValueError.
    """

    mode: str
    kw: tuple
    ks: tuple
    per: int
    checks: tuple = ()
    refused: bool = False


def ns_per_unit(case: Case, ms) -> float:
    """ns per unit per tile from the times (ms) at ``case.ks``."""
    if len(case.ks) >= 2:
        return (ms[-1] - ms[0]) / (case.ks[-1] - case.ks[0]) / case.per * 1e6
    return ms[0] / case.per * 1e6


def inputs(script: str) -> dict:
    """The numpy inputs of ``script``'s main(), made as the script makes
    them (``np.random.default_rng(0)`` in the script's order)."""
    rng = np.random.default_rng(0)

    def tiles(nt, hi):
        return rng.integers(0, hi, (nt, SUB, LANE)).astype(np.int32)

    if script == "try_opcost":
        x = tiles(64, 100)
        return dict(x=x, idx=tiles(64, LANE))
    if script == "try_reduce":
        return dict(x=tiles(256, 100))
    if script in ("try_loopcost", "try_loopcost2"):
        return dict(x=np.zeros((64, SUB, LANE), np.int32))
    if script == "try_batchmin":
        return dict(x=tiles(64, 100))
    if script == "try_axis0":
        x = tiles(64, 100)
        return dict(x=x, idx=tiles(64, SUB))
    if script == "try_vgather":
        x = rng.integers(0, 1000, (SUB, LANE)).astype(np.int32)
        idx8 = rng.integers(0, SUB, (SUB, LANE)).astype(np.int32)
        x16 = rng.integers(0, 1000, (2 * SUB, LANE)).astype(np.int32)
        idx16 = rng.integers(0, 2 * SUB, (SUB, LANE)).astype(np.int32)
        return dict(x=x, idx=idx8, x16=x16, idx16=idx16)
    if script == "repro_roll24":
        return dict(x=np.arange(24, dtype=np.int32)[:, None]
                    * np.ones((1, LANE), np.int32))
    if script == "try_dyngrid":
        t = 240
        tl = np.zeros((t,), np.int32)
        tl[:4] = (3, 7, 100, 239)
        return dict(x=np.arange(t * SUB * LANE, dtype=np.int32).reshape(
            t, SUB, LANE), tile_list=tl)
    if script == "prim_bench":
        x = tiles(256, 100)
        idx = tiles(256, LANE)
        plane = rng.integers(0, 60000, (4, 64 + 2 * SUB, LANE)).astype(np.int32)
        return dict(x=x, idx=idx, plane=plane)
    raise ValueError(f"no probe script {script!r}")


def on(device, arrays: dict) -> dict:
    return {k: torch.as_tensor(v).to(device) for k, v in arrays.items()}


def check_tensor(what: str, t, shape, device=None):
    """Raise unless t is a contiguous int32 tensor of ``shape`` (None = any
    extent) on ``device`` (when given)."""
    if (not isinstance(t, torch.Tensor) or t.dtype != torch.int32
            or t.dim() != len(shape)
            or any(s is not None and s != n for s, n in zip(shape, t.shape))
            or (device is not None and t.device != device)):
        got = (f"{t.dtype} {tuple(t.shape)} on {t.device}"
               if isinstance(t, torch.Tensor) else type(t).__name__)
        raise ValueError(f"{what}: needs an int32 tensor of shape {shape}"
                         f"{'' if device is None else f' on {device}'}, got {got}")
    if device is not None and not t.is_contiguous():
        raise ValueError(f"{what}: needs a contiguous tensor")


def check_choice(what: str, value, choices):
    if value not in choices:
        raise ValueError(f"{what}: {value!r} is not one of {choices}")


def launch(entry: str, what: str, tensors, ints, out):
    """Call the C entry ``entry`` of the kernel library on the current
    stream as entry(*tensors, out, *ints, stream); raise on a CUDA error."""
    lib = cuda_lib.library()
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = getattr(lib, entry)(*[t.data_ptr() for t in tensors],
                                     out.data_ptr(), *ints, stream)
    cuda_lib.check(status, what)
    return out


def lane_gather(t, idx):
    """take_along_axis(t, idx, axis=1) of each (8, 128) tile; idx & 127."""
    return torch.gather(t, -1, (idx & (LANE - 1)).long())


def sublane_gather(t, idx):
    """take_along_axis(t, idx, axis=0) of each (8, 128) tile; idx & 7."""
    return torch.gather(t, -2, (idx & (SUB - 1)).long())


def tile_min(t):
    return t.amin(dim=(-2, -1), keepdim=True)


def tile_max(t):
    return t.amax(dim=(-2, -1), keepdim=True)


def table(probe, device, plain=False, iters=20):
    """The rows of ``probe``'s table, timed on the card: one dict per case
    with the mode, the counts, the ms at each and the ns per unit per tile.
    A refused case gives its error instead."""
    args = probe.inputs(device)
    rows = []
    for case in probe.CASES:
        if case.refused:
            try:
                probe.call(args, case, case.ks[0], plain)
            except ValueError as e:
                rows.append(dict(mode=case.mode, error=str(e)))
                continue
            raise AssertionError(f"{probe.SCRIPT} {case.mode} did not raise")
        ms = [graph_ms(lambda: probe.call(args, case, k, plain),
                       iters=iters, warmup=1 if plain else 2)
              for k in case.ks]
        rows.append(dict(mode=case.mode, ks=list(case.ks), ms=ms,
                         ns=ns_per_unit(case, ms)))
    return rows


def compare(probe, device):
    """Kernel against plain version on the card, for every case at every
    count it is timed or checked at: one dict per case with the counts
    compared, the mismatching elements and the largest |difference|.  A
    refused case must raise ValueError on both sides."""
    args = probe.inputs(device)
    rows = []
    for case in probe.CASES:
        if case.refused:
            for plain in (False, True):
                try:
                    probe.call(args, case, case.ks[0], plain)
                except ValueError:
                    continue
                raise AssertionError(f"{probe.SCRIPT} {case.mode} did not raise")
            rows.append(dict(mode=case.mode, refused=True, mismatches=0,
                             max_abs_err=0))
            continue
        mism, err = 0, 0
        for k in case.ks + case.checks:
            got = probe.call(args, case, k, False)
            want = probe.call(args, case, k, True)
            diff = (got.long() - want.long()).abs()
            mism += int((diff != 0).sum())
            err = max(err, int(diff.max()))
        rows.append(dict(mode=case.mode, ks=list(case.ks + case.checks),
                         mismatches=mism, max_abs_err=err))
    return rows


def require_cuda(what: str):
    if not torch.cuda.is_available():
        raise SystemExit(f"{what}: needs a CUDA device "
                         "(torch.cuda.is_available() is False)")
    return torch.device("cuda", 0)


def print_table(name: str, rows):
    print(f"{name}  ({torch.cuda.get_device_name(0)})")
    for r in rows:
        if "error" in r:
            print(f"  {r['mode']:16s}      FAIL  ValueError: {r['error'][:90]}")
            continue
        at = ", ".join(f"k={k}: {ms:.4f} ms" for k, ms in zip(r["ks"], r["ms"]))
        print(f"  {r['mode']:16s} {r['ns']:10.2f} ns/unit/tile  ({at})")
    sys.stdout.flush()


def main(probe):
    """Print ``probe``'s table measured on the card; exit non-zero without
    one."""
    dev = require_cuda(probe.SCRIPT)
    print_table(probe.SCRIPT, table(probe, dev))
