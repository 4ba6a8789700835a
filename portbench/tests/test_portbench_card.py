"""On the card: the benchmark's own command, each cell for a few seconds,
untraced and traced, comes out correct with every metric it owes."""

import json
import subprocess
import sys

import pytest

from portbench.lib import harness


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in
                                  harness.manifest()["workloads"]])
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_correct(card, cell, trace):
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell, "--seed",
         str(2 ** 33 + 77), "--seconds", "3", "--trace", str(trace)],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["compared"]
    man = harness.manifest()
    kind = "per_layer" if trace else "end_to_end"
    want = {m["name"] for m in man[kind] if harness.applies(m, cell, man)}
    if not trace:
        assert set(res["metrics"]) == want
    else:
        assert set(res["metrics"]) <= want and res["device"]["busy_s"] > 0
