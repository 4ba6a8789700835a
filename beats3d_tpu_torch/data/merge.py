# Copied from beats3d_tpu/data/merge.py (numpy / host only).
"""Merge labeled datasets under a label-remapping plan.

The plan JSON is the reference's artifact schema (src/merge_datasets.py is
the spec for the FORMAT only):

    {"datasets": [[dir, id], ...],
     "labels": {"<out_label>": {"<dataset_id>": in_label,
                                "new_color": [r, g, b]}}}

Everything is array-level here: each source loads through the standard
dataset reader, labels remap through a per-dataset LUT in one vectorized
take, and the merged set is written by data.dataset.write_dataset.
"""

from __future__ import annotations

import json
from typing import Dict, Optional

import numpy as np

from .dataset import DatasetConfig, write_dataset


def load_plan(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def merge_datasets(
    plan: dict, out_dir: str, images_per_set: Optional[int] = None, log=print
) -> Dict:
    """Execute a merge plan; returns the merged config dict.

    ``images_per_set`` caps how many images each source contributes
    (the reference CLI's --only_one debug flag generalized).
    """
    def open_all(path: str) -> DatasetConfig:
        n = DatasetConfig(path).total_available_images
        return DatasetConfig(
            path, num_images=n, images_per_block=n,
            image_idxes=list(range(n)),
        )

    sources = {
        int(set_id): open_all(path) for path, set_id in plan["datasets"]
    }
    out_labels_spec = plan["labels"]
    num_out = len(out_labels_spec)

    dims = {src.img_dims for src in sources.values()}
    if len(dims) != 1:
        raise ValueError(f"datasets disagree on image dims: {dims}")

    # per-source LUT: source label id -> merged label id (0 stays background)
    max_in = 1 + max(
        int(spec[str(sid)])
        for spec in out_labels_spec.values()
        for sid in sources
    )
    luts = {sid: np.zeros(max_in + 1, np.uint16) for sid in sources}
    id_to_color = {}
    for out_id_str, spec in out_labels_spec.items():
        out_id = int(out_id_str)
        id_to_color[out_id] = np.array(
            list(spec["new_color"])[:3] + [255], np.uint8
        )
        for sid in sources:
            src = int(spec[str(sid)])
            if src > 0:  # 0 = this dataset has no source for the label
                luts[sid][src] = out_id

    depth_parts = []
    label_parts = []
    for sid, src in sorted(sources.items()):
        take = src.num_images
        if images_per_set:
            take = min(take, images_per_set)
        log(f"merging set {sid}: {take} images")
        depth = np.concatenate(
            [src.get_depth_block(b) for b in range(src.num_image_blocks)]
        )[:take]
        labels = np.concatenate(
            [src.get_labels_block(b) for b in range(src.num_image_blocks)]
        )[:take]
        depth_parts.append(depth)
        label_parts.append(luts[sid][labels])

    write_dataset(
        out_dir,
        np.concatenate(depth_parts),
        np.concatenate(label_parts),
        id_to_color,
    )
    return {
        "num_images": sum(d.shape[0] for d in depth_parts),
        "num_classes": num_out + 1,
    }
