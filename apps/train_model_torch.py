#!/usr/bin/env python3
"""Train a per-pixel classifier RDF on a labeled depth dataset with the
PyTorch/CUDA port (beats3d_tpu_torch): the CLI of apps/train_model.py, minus
``--mesh``, plus ``--device``.  Reading a PNG dataset needs Pillow.

Example:
  python apps/train_model_torch.py -d dataset/ --train 128 --train_block 4 \\
      --test 8 --proposals 128 --proposals_block 64 --out_trees 4 \\
      --trees_to_try 8 --depth 16 -o model.npy --seed 0
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402

from beats3d_tpu_torch.data.dataset import DatasetConfig  # noqa: E402
from beats3d_tpu_torch.train import train_forest  # noqa: E402


def main():
    parser = argparse.ArgumentParser(
        description="Train a classifier RDF for depth images (PyTorch/CUDA)"
    )
    parser.add_argument("--train", required=True, type=int,
                        help="Num training images")
    parser.add_argument("--train_block", required=False, type=int,
                        help="Images per training block (default: all)")
    parser.add_argument("--test", required=True, type=int,
                        help="Num test images")
    parser.add_argument("--proposals", required=True, type=int,
                        help="Num proposals tested per node")
    parser.add_argument("--proposals_block", required=True, type=int,
                        help="Num proposals per proposal block")
    parser.add_argument("--out_trees", required=True, type=int,
                        help="Num trees in final forest")
    parser.add_argument("--trees_to_try", required=False, type=int,
                        help="Num candidate trees generated for forest")
    parser.add_argument("--depth", required=True, type=int,
                        help="Max depth for a tree in the forest")
    parser.add_argument("-o", "--out", required=True, type=str,
                        help="Where to save the output model")
    parser.add_argument("-d", "--data", required=True, type=str,
                        help="Directory containing the training data")
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument("--streaming", action="store_true",
                        help="Ship image blocks host->device per use "
                             "(bounded device memory; compressed host storage)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device: cuda (the CUDA kernels) or cpu "
                             "(their plain versions)")
    args = parser.parse_args()

    print("loading training data")
    train_data, test_data = DatasetConfig.multiple(args.data, [
        (args.train, args.train_block, "train"),
        (args.test, None, "test"),
    ])

    if args.streaming:
        from beats3d_tpu_torch.data.blocks import CompressedDataset
        train_data = CompressedDataset(train_data)
        print(f"streaming compressed blocks: depth "
              f"{train_data.depth.compression_ratio:.1f}x, labels "
              f"{train_data.labels.compression_ratio:.1f}x")

    forest = train_forest(
        train_data,
        test_data,
        num_random_features=args.proposals,
        proposals_per_block=args.proposals_block,
        images_per_block=args.train_block,
        max_tree_depth=args.depth,
        trees_in_forest=args.out_trees,
        trees_to_try=args.trees_to_try,
        rng=np.random.default_rng(args.seed),
        streaming=args.streaming,
        device=args.device,
    )

    print("saving model output!")
    forest.save(args.out)


if __name__ == "__main__":
    main()
