"""Tests of the benchmark harness (``python -m pytest portbench/tests -q``).

They run on the CPU at a small size (424x240 frames, few scenes, a shallow
tree), driving the port's plain versions; the tests marked ``cuda`` run the
benchmark's own command on the card and skip elsewhere.  No test here
imports JAX or the JAX package.
"""

import copy
import os
import sys
import tempfile
import time

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench.lib import harness  # noqa: E402

SEED = 2 ** 33 + 5     # a run takes seeds past 32 bits


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: runs the benchmark on an NVIDIA card; skips "
        "without one")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)


def small(cell: str):
    """(manifest, cell entry, configuration, workload) of ``cell`` cut to a
    size the CPU runs in seconds: 424x240 frames, 4 scenes, 256 plane
    candidates, 2 warm-up frames; for training 4 + 2 frames, depth 6, 64
    proposals in blocks of 32, 2 images a block."""
    man = harness.manifest()
    entry = harness.find(man["workloads"], cell, "cell")
    cfg = copy.deepcopy(harness.load_json(os.path.join(ROOT, harness.find(
        man["configs"], entry["config"], "configuration")["file"])))
    wl = copy.deepcopy(harness.load_json(os.path.join(
        harness.BENCH, "workloads", cell + ".json")))
    cfg["camera"] = {"width": 424, "height": 240, "fx": 212.5, "fy": 212.5,
                     "ppx": 212.0, "ppy": 120.0}
    if "pipeline" in cfg:
        cfg["pipeline"].update(height=240, width=424)
        if wl["driver"] != "live":
            # the live app builds its own crop window (448x512: the full
            # frame at this size); the batched call takes a smaller one
            cfg["pipeline"].update(crop_h=224, crop_w=256)
        cfg["plane"]["num_candidates"] = 256
        cfg["app"].update(plane_num_iterations=256, warmup_frames=2)
        wl["traffic"]["scenes"] = 4
        wl["traffic"]["oversized"] = min(wl["traffic"]["oversized"], 1)
    if "training" in cfg:
        cfg["training"].update(depth=6, proposals=64, proposals_per_block=32,
                               images_per_block=2, train_frames=4,
                               test_frames=2)
        wl["traffic"].update(train=4, test=2)
    return man, entry, cfg, wl


def run_small(cell: str, seconds: float = 1.0, seed: int = SEED):
    """One run of ``cell`` at the small size on the CPU: (result line,
    checks table)."""
    import torch
    man, entry, cfg, wl = small(cell)
    return harness.run_cell(man, entry, seed=seed, seconds=seconds,
                            trace=False, device=torch.device("cpu"),
                            tmpdir=tempfile.gettempdir(),
                            t_start=time.perf_counter(), config=cfg,
                            workload=wl)
