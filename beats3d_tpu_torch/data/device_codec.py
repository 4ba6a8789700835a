"""Run-length coded training blocks decoded on the device (counterpart of
beats3d_tpu/data/device_codec.py).

The reference decompresses its training blocks on the GPU with nvcomp, so
only compressed bytes cross from the host.  Here the host run-length codes a
block (:func:`rle_encode`, numpy), ships the (values, run lengths) buffers,
and the device rebuilds the dense block with a cumsum and a
``searchsorted`` gather (:func:`rle_decode`).  A block whose run count
exceeds the budget ships raw.  The streaming trainer keeps depth, labels and
the per-pixel node ids in :class:`DeviceCodecDynamic` stores.
"""

from __future__ import annotations

import itertools
from typing import Tuple

import numpy as np
import torch

# numpy dtype -> torch dtype of a decoded block
_TORCH_DTYPES = {
    np.dtype(np.uint8): torch.uint8,
    np.dtype(np.uint16): torch.uint16,
    np.dtype(np.int16): torch.int16,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.float32): torch.float32,
}


def _rle_host(flat: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(values, run_lengths) of a 1-D array."""
    n = flat.shape[0]
    if n == 0:
        return flat[:0], np.zeros(0, np.int32)
    edges = np.flatnonzero(flat[1:] != flat[:-1]) + 1
    starts = np.concatenate([[0], edges])
    lengths = np.diff(np.concatenate([starts, [n]]))
    return flat[starts], lengths.astype(np.int32)


def rle_encode(arr: np.ndarray, budget: int):
    """Encode ``arr`` into fixed-size RLE buffers.

    Returns (values (budget,), lengths (budget,) int32, n_runs, raw);
    ``raw=True`` (values and lengths None) means the block has more runs
    than ``budget`` and ships raw."""
    flat = np.ascontiguousarray(arr).reshape(-1)
    vals, lens = _rle_host(flat)
    if len(vals) > budget:
        return None, None, len(vals), True
    v = np.zeros(budget, arr.dtype)
    l = np.zeros(budget, np.int32)
    v[: len(vals)] = vals
    l[: len(lens)] = lens
    return v, l, len(vals), False


def rle_decode(values: torch.Tensor, lengths: torch.Tensor, *, n: int, shape,
               dtype: torch.dtype) -> torch.Tensor:
    """Rebuild the dense block on the buffers' device.

    out[i] = values[j] for the run j covering position i: the runs' end
    offsets are an inclusive cumsum of the lengths (padding runs have length
    0 and cover nothing), and one ``searchsorted`` maps positions to runs.
    The gather runs on a widened copy of the values (torch lacks indexing
    kernels for uint16)."""
    ends = torch.cumsum(lengths.to(torch.int64), 0)
    pos = torch.arange(n, dtype=torch.int64, device=values.device)
    run = torch.searchsorted(ends, pos, right=True)
    wide = values.to(torch.float32 if dtype == torch.float32 else torch.int64)
    out = wide[run.clamp(0, values.shape[0] - 1)]
    return out.reshape(shape).to(dtype)


def _encode_one(arr: np.ndarray, cap: int):
    """(vals, lens | None, raw): RLE buffers padded to a power of two, or the
    raw array when the run count exceeds ``cap``."""
    flat = np.ascontiguousarray(arr).reshape(-1)
    vals, lens = _rle_host(flat)
    nruns = len(vals)
    if nruns > cap:
        return np.ascontiguousarray(arr), None, True
    budget = 16
    while budget < nruns:
        budget *= 2
    v = np.zeros(budget, arr.dtype)
    l = np.zeros(budget, np.int32)
    v[:nruns] = vals
    l[:nruns] = lens
    return v, l, False


class _CodecStore:
    """Per-block RLE buffers (or raw arrays) on the host, decoded on
    ``device`` by :meth:`get_block`."""

    def __init__(self, shape, dtype, device, budget_frac: float):
        self.shape = tuple(shape)
        self.dtype = np.dtype(dtype)
        self.torch_dtype = _TORCH_DTYPES[self.dtype]
        self.device = torch.device(device)
        self.n = int(np.prod(self.shape))
        self.cap = max(16, int(self.n * budget_frac))
        self._vals, self._lens, self._raw = [], [], []

    def get_block(self, i: int) -> torch.Tensor:
        """Block ``i``, dense, on the store's device; only the encoded
        buffers cross host to device."""
        vals = torch.as_tensor(self._vals[i]).to(self.device)
        if self._raw[i]:
            return vals
        lens = torch.as_tensor(self._lens[i]).to(self.device)
        return rle_decode(vals, lens, n=self.n, shape=self.shape,
                          dtype=self.torch_dtype)

    def compressed_bytes(self) -> int:
        return sum(v.nbytes + (l.nbytes if l is not None else 0)
                   for v, l in zip(self._vals, self._lens) if v is not None)

    def raw_bytes(self) -> int:
        return sum(self.n * self.dtype.itemsize
                   for v in self._vals if v is not None)

    def compression_ratio(self) -> float:
        return self.raw_bytes() / max(1, self.compressed_bytes())


class DeviceCodecDynamic(_CodecStore):
    """Rewritable per-block store (the per-level node-id state), the codec
    counterpart of blocks.CompressedBlocksDynamic."""

    def __init__(self, num_blocks: int, shape, dtype, device="cpu",
                 budget_frac: float = 0.25):
        super().__init__(shape, dtype, device, budget_frac)
        self._vals = [None] * num_blocks
        self._lens = [None] * num_blocks
        self._raw = [False] * num_blocks

    def write_block(self, i: int, arr: np.ndarray):
        assert tuple(arr.shape) == self.shape
        v, l, raw = _encode_one(arr.astype(self.dtype, copy=False), self.cap)
        self._vals[i], self._lens[i], self._raw[i] = v, l, raw


class DeviceCodecBlocks(_CodecStore):
    """Encode-once store of same-shape numpy blocks, the codec counterpart
    of blocks.CompressedBlocksStatic.  Each block's buffers are sized to the
    next power of two above its run count; a block needing more than
    ``budget_frac`` of the dense element count in runs ships raw."""

    def __init__(self, blocks, device="cpu", budget_frac: float = 0.25):
        blocks = iter(blocks)
        first = next(blocks, None)
        assert first is not None, "empty block list"
        super().__init__(first.shape, first.dtype, device, budget_frac)
        for b in itertools.chain([first], blocks):  # one block at a time
            assert b.shape == self.shape and b.dtype == self.dtype
            v, l, raw = _encode_one(b, self.cap)
            self._vals.append(v)
            self._lens.append(l)
            self._raw.append(raw)

    def __len__(self):
        return len(self._vals)
