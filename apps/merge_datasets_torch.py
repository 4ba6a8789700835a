#!/usr/bin/env python3
"""Merge labelled datasets with per-dataset label remapping, with the
PyTorch/CUDA port's package (beats3d_tpu_torch): the CLI of
apps/merge_datasets.py.  The merge is numpy on the host (no device); reading
and writing the PNG datasets needs Pillow.

Example:
  python apps/merge_datasets_torch.py -m plan.json -o merged/
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from beats3d_tpu_torch.data.merge import load_plan, merge_datasets  # noqa: E402


def run(argv=None):
    parser = argparse.ArgumentParser(description="Combine multiple datasets")
    parser.add_argument("-m", "--mapping", required=True, type=str,
                        help="Path to JSON file describing merge")
    parser.add_argument("-o", "--out", required=True, type=str,
                        help="Out directory for merged dataset")
    parser.add_argument("--only_one", action="store_true",
                        help="Only take one image per source (debug)")
    args = parser.parse_args(argv)

    result = merge_datasets(
        load_plan(args.mapping), args.out,
        images_per_set=1 if args.only_one else None,
    )
    print(f"merged {result['num_images']} images "
          f"({result['num_classes'] - 1} classes) into {args.out}")
    return result


def main(argv=None):
    """The command line and the ``b3d-merge-datasets-torch`` console script:
    :func:`run`, its result dropped (a console script exits with what
    ``main`` returns)."""
    run(argv)


if __name__ == "__main__":
    main()
