#!/usr/bin/env python3
"""Offline forest evaluation on a saved dataset with the PyTorch/CUDA port:
prints pct_match and writes rendered label PNGs (the CLI of
apps/test_on_saved_model.py with ``--device`` in place of ``--backend``).
On a card the forest runs through the CUDA kernel, on the CPU through its
plain version.  Reading the dataset and writing renders need Pillow."""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from beats3d_tpu_torch.data.dataset import DatasetConfig  # noqa: E402
from beats3d_tpu_torch.models import DecisionForest  # noqa: E402
from beats3d_tpu_torch.ops.forest_eval_cuda import evaluate_forest_cuda  # noqa: E402
from beats3d_tpu_torch.train import pct_match  # noqa: E402

MAX_UINT16 = 65535


def main():
    parser = argparse.ArgumentParser(
        description="Evaluate a saved RDF model on a saved dataset (PyTorch/CUDA)"
    )
    parser.add_argument("-m", "--model", required=True, type=str,
                        help="Path to .npy model input file")
    parser.add_argument("-d", "--data", required=True, type=str,
                        help="Directory holding data")
    parser.add_argument("-o", "--out", required=True, type=str,
                        help="Directory to save output renderings")
    parser.add_argument("--test", required=True, type=int,
                        help="Num images to evaluate")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device: cuda (the CUDA kernel) or cpu "
                             "(its plain version)")
    args = parser.parse_args()

    print("loading forest")
    forest = DecisionForest.load(args.model)
    flat = torch.as_tensor(forest.data, device=args.device)

    print("loading data")
    dataset = DatasetConfig(args.data, num_images=args.test, name="test")
    depth = dataset.get_depth_block(0)
    labels = dataset.get_labels_block(0)

    print("evaluating forest..")
    d = torch.as_tensor(depth.astype(np.int32), device=args.device)
    pred = evaluate_forest_cuda(d, flat).cpu().numpy()

    print("FOREST pct. matching pixels: ", pct_match(pred, labels))

    print("saving forest renders..")
    os.makedirs(args.out, exist_ok=True)
    from PIL import Image

    renders = dataset.convert_ids_to_colors(np.where(pred == MAX_UINT16, 0, pred))
    for i in range(dataset.num_images):
        Image.fromarray(renders[i]).save(
            os.path.join(args.out, f"eval_labels_{i:08d}.png")
        )


if __name__ == "__main__":
    main()
