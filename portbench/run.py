#!/usr/bin/env python3
"""The benchmark of beats3d_tpu_torch on an NVIDIA H100: one run of one
cell of ``BENCHMARK.json``.

    python3 portbench/run.py --workload CELL --seed N --seconds S --trace 0|1

from the root of a checkout.  It makes the cell's inputs from the seed,
loads the committed model, builds the port's kernels into the checkout's
``build/`` (the first run of a checkout) or loads them from there, warms
up the cell's own shapes (set-up), measures for ``--seconds`` seconds,
compares what the timed path produced with the plain reference
(``portbench/reference``), and prints the numbers compared beside their
limits as the last lines of standard error and one JSON result as the
last line of standard output.  With ``--trace 1`` the metrics are the
cell's per-layer metrics, read from the same window and from a traced
window after it.  Exits 3, with no result, without a CUDA card (or fewer
than the cell asks for), when the port is absent, or when JAX or the JAX
package was loaded.  See portbench/README.md.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from portbench.lib import harness  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    harness.set_env()
    try:
        man = harness.manifest()
        cell = harness.find(man["workloads"], args.workload, "cell")
        import torch
        found = (torch.cuda.device_count() if torch.cuda.is_available()
                 else 0)
        if found < cell["chips"]:
            raise harness.Refused(
                f"needs {cell['chips']} CUDA device(s), found {found}")
        torch.cuda.set_device(0)
        result, table = harness.run_cell(
            man, cell, seed=args.seed, seconds=args.seconds,
            trace=bool(args.trace), device=torch.device("cuda", 0),
            tmpdir=tempfile.gettempdir(), t_start=T_START)
    except (harness.Refused, ImportError, FileNotFoundError) as e:
        print(f"portbench: no result: {type(e).__name__}: {e}",
              file=sys.stderr)
        return 3
    harness.emit(result, table)
    return 0


if __name__ == "__main__":
    sys.exit(main())
