"""Compressed in-memory block stores for training data (host numpy and
zlib; counterpart of beats3d_tpu/data/blocks.py).

The reference keeps its training set on the GPU as nvcomp-compressed blocks,
decompressed per use (CompressedBlocksStatic), and re-compresses the mutable
per-pixel node-id state every level (CompressedBlocksDynamic).  These
classes keep the same economy on the host with zlib: blocks decompress into
numpy and ship to the device per use.  Depth and label images compress well
(long constant runs).
"""

from __future__ import annotations

import zlib
from typing import Callable, List, Tuple

import numpy as np


class CompressedBlocksStatic:
    """Compress-once, read-many image blocks (reference
    compressed_blocks.py:96-208)."""

    def __init__(
        self,
        num_blocks: int,
        images_per_block: int,
        img_dims: Tuple[int, int],
        fill_block: Callable[[int, np.ndarray], None],
        name: str = "blocks",
        dtype=np.uint16,
        level: int = 1,
    ):
        self.num_blocks = num_blocks
        self.shape = (images_per_block, img_dims[1], img_dims[0])
        self.dtype = np.dtype(dtype)
        self.name = name
        self.level = level
        self._blobs: List[bytes] = []
        scratch = np.zeros(self.shape, self.dtype)
        raw = 0
        packed = 0
        for i in range(num_blocks):
            fill_block(i, scratch)
            blob = zlib.compress(scratch.tobytes(), level)
            self._blobs.append(blob)
            raw += scratch.nbytes
            packed += len(blob)
        self.raw_bytes = raw
        self.compressed_bytes = packed

    def get_block(self, i: int) -> np.ndarray:
        return np.frombuffer(
            zlib.decompress(self._blobs[i]), self.dtype
        ).reshape(self.shape)

    @property
    def compression_ratio(self) -> float:
        return self.raw_bytes / max(1, self.compressed_bytes)


class CompressedBlocksDynamic:
    """Re-writable compressed blocks (the per-pixel node-id state rewritten
    every training level; reference compressed_blocks.py:9-93)."""

    def __init__(self, num_blocks: int, images_per_block: int,
                 img_dims: Tuple[int, int], dtype=np.int32,
                 name: str = "nodes_by_pixel", level: int = 1):
        self.num_blocks = num_blocks
        self.shape = (images_per_block, img_dims[1], img_dims[0])
        self.dtype = np.dtype(dtype)
        self.name = name
        self.level = level
        empty = zlib.compress(
            np.zeros(self.shape, self.dtype).tobytes(), level
        )
        self._blobs: List[bytes] = [empty] * num_blocks

    def write_block(self, i: int, arr: np.ndarray):
        assert arr.shape == self.shape and arr.dtype == self.dtype
        self._blobs[i] = zlib.compress(np.ascontiguousarray(arr).tobytes(),
                                       self.level)

    def get_block(self, i: int) -> np.ndarray:
        return np.frombuffer(
            zlib.decompress(self._blobs[i]), self.dtype
        ).reshape(self.shape)

    @property
    def raw_bytes(self) -> int:
        return self.num_blocks * int(np.prod(self.shape)) * self.dtype.itemsize

    @property
    def compressed_bytes(self) -> int:
        return sum(len(b) for b in self._blobs)

    @property
    def compression_ratio(self) -> float:
        return self.raw_bytes / max(1, self.compressed_bytes)


class CompressedDataset:
    """Dataset adapter with the trainer's block interface but zlib-compressed
    host storage (a drop-in for DatasetConfig/ArrayDataset when the dataset
    outgrows RAM)."""

    def __init__(self, dataset):
        self._num_classes = dataset.num_classes()
        self.img_dims = dataset.img_dims
        self.num_images = dataset.num_images
        self.images_per_block = dataset.images_per_block
        self.num_image_blocks = dataset.num_image_blocks
        w, h = dataset.img_dims

        self.depth = CompressedBlocksStatic(
            dataset.num_image_blocks, dataset.images_per_block,
            dataset.img_dims,
            lambda i, a: a.__setitem__(slice(None), dataset.get_depth_block(i)),
            "depth",
        )
        self.labels = CompressedBlocksStatic(
            dataset.num_image_blocks, dataset.images_per_block,
            dataset.img_dims,
            lambda i, a: a.__setitem__(slice(None), dataset.get_labels_block(i)),
            "labels",
        )

    def num_classes(self):
        return self._num_classes

    def num_pixels(self):
        return self.num_images * self.img_dims[0] * self.img_dims[1]

    def get_depth_block(self, i):
        return self.depth.get_block(i)

    def get_labels_block(self, i):
        return self.labels.get_block(i)
