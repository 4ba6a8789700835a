"""python -m beats3d_tpu_torch.parallel --ranks N --device cuda|cpu: the
multi-rank dry run (:func:`.dryrun.dryrun_multichip`)."""

import argparse

from .dryrun import dryrun_multichip


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Run the sharded training step, tree-sharded eval, the "
                    "mesh trainer and batch_sharded once on N ranks")
    parser.add_argument("--ranks", type=int, default=4)
    parser.add_argument("--device", default="cuda",
                        help="cuda (the kernels; nccl when each rank has a "
                             "card, else gloo) or cpu (gloo, plain versions)")
    args = parser.parse_args(argv)
    dryrun_multichip(args.ranks, args.device)


if __name__ == "__main__":
    main()
