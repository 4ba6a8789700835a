"""The readers of the metrics that read the program's own spans, stage
stamps and counts: each reads its value from a synthetic record (or a
stand-in for the program's stage registry), and returns None where what it
reads is absent, as on a program without them."""

import sys
import types

import pytest

# loaded whole before a test stands in for its profiler module
import beats3d_tpu_torch.utils.profiler  # noqa: F401
from portbench.lib import harness

LIVE_SPANS = {"upload_ms.live": "upload", "device_wait_ms.live": "wait"}
STAGES = ("front", "eval", "meanshift", "heights")
TRAIN_RANGES = {"histogram_ms.train": "train.histogram",
                "gains_ms.train": "train.gains",
                "advance_ms.train": "train.advance",
                "sync_wait_ms.train": "train.sync"}
REGISTRY = {"frame_step": {s: 0.1 * (i + 1) for i, s in enumerate(STAGES)},
            "frame_step_batched": {s: 1.0 + i for i, s in enumerate(STAGES)}}


def _program(monkeypatch, registry=None):
    """The program's profiler module as the readers import it: with a
    stage registry returning ``registry``, or (None) without stage_ms, as
    before the stamps."""
    mod = types.ModuleType("beats3d_tpu_torch.utils.profiler")
    if registry is not None:
        mod.stage_ms = lambda: registry
    monkeypatch.setitem(sys.modules, "beats3d_tpu_torch.utils.profiler", mod)


def test_manifest_lists_each_reader():
    man = harness.manifest()
    names = {m["name"] for m in man["per_layer"]}
    want = set(LIVE_SPANS) | set(TRAIN_RANGES) | {"syncs_per_tree.train"} | {
        f"{s}_ms.{c}" for s in STAGES for c in ("live", "batch")}
    assert want <= names


@pytest.mark.parametrize("name,span", sorted(LIVE_SPANS.items()))
def test_live_span_readers(name, span):
    read = harness.reader(name)
    spans = {"upload": 0.33, "wait": 0.28, "frame_step": 0.17}
    assert read({"tick_s": [1e-3], "spans": spans}) == spans[span]
    assert read({"tick_s": [1e-3], "spans": {"frame_step": 0.17}}) is None
    assert read({"tick_s": [1e-3]}) is None


@pytest.mark.parametrize("stage", STAGES)
def test_stage_readers(monkeypatch, stage):
    live = harness.reader(f"{stage}_ms.live")
    batch = harness.reader(f"{stage}_ms.batch")
    _program(monkeypatch, REGISTRY)
    assert live({"tick_s": [1e-3]}) == REGISTRY["frame_step"][stage]
    assert batch({"batch": 16}) == REGISTRY["frame_step_batched"][stage]
    # each reads only its own cells' program
    assert live({"batch": 16}) is None and batch({"tick_s": [1e-3]}) is None
    _program(monkeypatch, {"frame_step": REGISTRY["frame_step"]})
    assert batch({"batch": 16}) is None
    _program(monkeypatch, {})
    assert live({"tick_s": [1e-3]}) is None
    _program(monkeypatch)                   # a program without stamps
    assert live({"tick_s": [1e-3]}) is None
    assert batch({"batch": 16}) is None


def _train_rec(ranges, calls=1):
    return {"trees": 3, "trace": {"calls": calls, "ranges": ranges}}


@pytest.mark.parametrize("name,rng", sorted(TRAIN_RANGES.items()))
def test_train_range_readers(name, rng):
    read = harness.reader(name)
    assert read(_train_rec({rng: [2.5, 40], "finalize": [0.2, 16]})) == (
        pytest.approx(2500.0))
    assert read(_train_rec({rng: [2.5, 40]}, calls=2)) == pytest.approx(1250.0)
    assert read(_train_rec({"finalize": [0.2, 16]})) is None
    assert read({"trees": 3, "trace": None}) is None
    assert read({"trace": {"calls": 1, "ranges": {rng: [2.5, 40]}}}) is None


def test_syncs_per_tree_reads_the_count():
    read = harness.reader("syncs_per_tree.train")
    assert read(_train_rec({"train.sync": [1.8, 6475]})) == 6475
    assert read(_train_rec({"train.sync": [1.8, 6475]}, calls=5)) == 1295
    assert read(_train_rec({"finalize": [0.2, 16]})) is None
    assert read({"trees": 3, "trace": None}) is None
