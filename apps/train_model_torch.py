#!/usr/bin/env python3
"""Train a per-pixel classifier RDF on a labeled depth dataset with the
PyTorch/CUDA port (beats3d_tpu_torch): the CLI of apps/train_model.py, plus
``--device``.  Reading a PNG dataset needs Pillow.

``--mesh DATAxMODEL`` trains on a grid of ranks (histograms data-parallel
over images, proposals split over ``model``; the same trees as one device).
Under ``torchrun --nproc_per_node N`` each process is a rank; otherwise the
app spawns the N ranks itself.  Ranks sharing one card (or the CPU) talk
over gloo, one card per rank over nccl.  Rank 0 saves the model.

Example:
  python apps/train_model_torch.py -d dataset/ --train 128 --train_block 4 \\
      --test 8 --proposals 128 --proposals_block 64 --out_trees 4 \\
      --trees_to_try 8 --depth 16 -o model.npy --seed 0 [--mesh 2x2]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402

from beats3d_tpu_torch.data.dataset import DatasetConfig  # noqa: E402
from beats3d_tpu_torch.parallel import launch, make_mesh  # noqa: E402
from beats3d_tpu_torch.train import train_forest  # noqa: E402


def train(device, args, train_data, test_data, mesh_shape=None):
    """Train the forest on ``device``, on a mesh of that shape when given
    (this process is then one of its ranks); only rank 0 logs."""
    mesh, log = None, print
    if mesh_shape is not None:
        mesh = make_mesh(*mesh_shape, device=device)
        if mesh.rank == 0:
            print(f"training on mesh data={mesh_shape[0]} "
                  f"model={mesh_shape[1]} ({mesh.backend}, {mesh.device})")
        else:
            log = lambda *a: None  # noqa: E731
    if args.streaming:
        from beats3d_tpu_torch.data.blocks import CompressedDataset
        train_data = CompressedDataset(train_data)
        log(f"streaming compressed blocks: depth "
            f"{train_data.depth.compression_ratio:.1f}x, labels "
            f"{train_data.labels.compression_ratio:.1f}x")
    return train_forest(
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
        device=device,
        mesh=mesh,
        log=log,
    )


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
    parser.add_argument("--mesh", type=str, default=None,
                        help="Train on a grid of ranks, 'DATAxMODEL' (e.g. "
                             "2x2): histograms data-parallel over images and "
                             "model-parallel over proposals, the same trees "
                             "as one device")
    args = parser.parse_args()
    shape = None
    if args.mesh:
        shape = tuple(int(v) for v in args.mesh.split("x"))
    rank0 = True
    if shape is not None and launch.under_torchrun():
        device = launch.init_from_env(args.device)
        rank0 = int(os.environ["RANK"]) == 0

    if rank0:
        print("loading training data")
    # the split draws from the global numpy rng: rank 0 makes it
    datasets = [None, None]
    if rank0:
        datasets = list(DatasetConfig.multiple(args.data, [
            (args.train, args.train_block, "train"),
            (args.test, None, "test"),
        ]))

    if shape is None:
        forest = train(args.device, args, *datasets)
    elif launch.under_torchrun():
        import torch.distributed as dist
        dist.broadcast_object_list(datasets, src=0)
        forest = train(device, args, *datasets, shape)
        dist.destroy_process_group()
    else:
        forests = launch.spawn(train, shape[0] * shape[1], device=args.device,
                               args=(args, *datasets, shape))
        forest = forests[0]
        if any(f.data.tobytes() != forest.data.tobytes() for f in forests):
            raise RuntimeError("the ranks trained different forests")

    if rank0:
        print("saving model output!")
        forest.save(args.out)


if __name__ == "__main__":
    main()
