"""Labeled depth-image datasets (host numpy; counterpart of
beats3d_tpu/data/dataset.py).

Directory format, as the reference writes it: ``config.json`` with
``img_dims`` (x, y), ``num_images`` and ``id_to_color`` (class id -> RGBA),
plus ``{idx:08d}_depth.png`` and ``{idx:08d}_labels.png`` (uint16 PNGs) per
image.  Every dataset splits into uniform image blocks, which the trainer
streams block by block.

Pillow is imported only where a PNG is read or written: the card machine
has none, and :class:`ArrayDataset` needs none.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np


def _image_module():
    from PIL import Image

    return Image


class DatasetConfig:
    """A named subset of a dataset directory, split into uniform image
    blocks (reference ``DecisionTreeDatasetConfig``)."""

    def __init__(
        self,
        dataset_dir: str,
        num_images: int = 0,
        images_per_block: int = 0,
        name: str = "data0",
        image_idxes: Optional[List[int]] = None,
    ):
        self.dataset_dir = dataset_dir
        with open(os.path.join(dataset_dir, "config.json")) as f:
            self.cfg = json.load(f)
        self.name = name

        self.img_dims: Tuple[int, int] = tuple(self.cfg["img_dims"])  # (x, y)
        self.id_to_color: Dict[int, np.ndarray] = {
            0: np.array([0, 0, 0, 0], dtype=np.uint8)
        }
        for i, c in self.cfg["id_to_color"].items():
            self.id_to_color[int(i)] = np.array(c, dtype=np.uint8)

        self.total_available_images = self.cfg["num_images"]
        self.num_images = num_images
        if num_images == 0:
            return

        self.images_per_block = images_per_block or num_images
        assert self.num_images % self.images_per_block == 0
        self.num_image_blocks = self.num_images // self.images_per_block

        if image_idxes is None:
            image_idxes = list(range(self.total_available_images))
            np.random.shuffle(image_idxes)
            image_idxes = image_idxes[: self.num_images]
        assert len(image_idxes) == self.num_images
        self.image_idxes = image_idxes
        self._cache: Dict[Tuple[str, int], np.ndarray] = {}

    @staticmethod
    def multiple(dataset_dir: str, subsets, *, rng=None, ordered=False):
        """Split a dataset directory into disjoint named subsets.

        ``subsets``: list of (num_images, images_per_block_or_None, name).
        The default shuffle draws from the GLOBAL numpy rng, as the
        reference and the JAX package do, so two processes get different
        splits; pass ``rng`` for a seeded shuffle, or ``ordered=True`` to
        take the images in file order.
        """
        with open(os.path.join(dataset_dir, "config.json")) as f:
            total = json.load(f)["num_images"]
        want = sum(n for n, _, _ in subsets)
        assert want <= total, (want, total)

        order = list(range(total))
        if not ordered:
            if rng is not None:
                rng.shuffle(order)
            else:
                np.random.shuffle(order)

        out, start = [], 0
        for num, per_block, name in subsets:
            out.append(
                DatasetConfig(
                    dataset_dir,
                    num_images=num,
                    images_per_block=per_block or num,
                    name=name,
                    image_idxes=order[start : start + num],
                )
            )
            start += num
        return tuple(out)

    # -- block access ------------------------------------------------------
    def _load_block(self, kind: str, block: int) -> np.ndarray:
        key = (kind, block)
        if key not in self._cache:
            image = _image_module()
            w, h = self.img_dims
            arr = np.zeros((self.images_per_block, h, w), dtype=np.uint16)
            for j in range(self.images_per_block):
                idx = self.image_idxes[block * self.images_per_block + j]
                path = os.path.join(self.dataset_dir, f"{idx:08d}_{kind}.png")
                arr[j] = np.array(image.open(path)).astype(np.uint16)
            self._cache[key] = arr
        return self._cache[key]

    def get_depth_block(self, block: int) -> np.ndarray:
        return self._load_block("depth", block)

    def get_labels_block(self, block: int) -> np.ndarray:
        return self._load_block("labels", block)

    # -- metadata ----------------------------------------------------------
    def num_classes(self) -> int:
        return len(self.id_to_color)

    def num_pixels(self) -> int:
        return self.num_images * self.img_dims[0] * self.img_dims[1]

    def images_shape(self) -> Tuple[int, int, int]:
        return (self.num_images, self.img_dims[1], self.img_dims[0])

    def convert_ids_to_colors(self, labels_ids: np.ndarray) -> np.ndarray:
        """(N, H, W) class ids -> (N, H, W, 4) RGBA renders."""
        n, h, w = labels_ids.shape
        assert (w, h) == self.img_dims
        out = np.zeros((n, h, w, 4), dtype=np.uint8)
        for class_id, color in self.id_to_color.items():
            out[labels_ids == class_id] = color
        return out


class ArrayDataset:
    """In-memory dataset with the block interface of :class:`DatasetConfig`
    (tests, synthetic data, and the card machine, which reads no PNG)."""

    def __init__(self, depth: np.ndarray, labels: np.ndarray,
                 num_classes: int, images_per_block: int = 0):
        assert depth.shape == labels.shape and depth.ndim == 3
        n, h, w = depth.shape
        self.depth = depth.astype(np.uint16)
        self.labels = labels.astype(np.uint16)
        self._num_classes = num_classes
        self.img_dims = (w, h)
        self.num_images = n
        self.images_per_block = images_per_block or n
        assert n % self.images_per_block == 0
        self.num_image_blocks = n // self.images_per_block

    def num_classes(self) -> int:
        return self._num_classes

    def images_shape(self):
        return self.depth.shape

    def num_pixels(self):
        return int(np.prod(self.depth.shape))

    def _blk(self, arr, i):
        s = i * self.images_per_block
        return arr[s : s + self.images_per_block]

    def get_depth_block(self, i):
        return self._blk(self.depth, i)

    def get_labels_block(self, i):
        return self._blk(self.labels, i)


def write_dataset(out_dir: str, depth: np.ndarray, labels: np.ndarray,
                  id_to_color: Dict[int, np.ndarray]):
    """Write (N, H, W) uint16 depth and labels plus config.json in the
    reference dataset format."""
    image = _image_module()
    os.makedirs(out_dir, exist_ok=True)
    n, h, w = depth.shape
    for i in range(n):
        image.fromarray(depth[i].astype(np.uint16)).save(
            os.path.join(out_dir, f"{i:08d}_depth.png"))
        image.fromarray(labels[i].astype(np.uint16)).save(
            os.path.join(out_dir, f"{i:08d}_labels.png"))
    cfg = {
        "img_dims": [w, h],
        "num_images": n,
        "id_to_color": {
            str(k): [int(x) for x in v] for k, v in id_to_color.items() if k != 0
        },
    }
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(cfg, f)
