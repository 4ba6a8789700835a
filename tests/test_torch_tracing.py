"""The port's tracer on the CPU: ProfileTimer's aggregates (bounded memory,
totals equal to the spans' sum), record_function entered only while
torch.profiler records, the named ranges of BeatsApp.tick,
FramePipeline.batch and train_forest nested as the program nests them, and
no output changed by tracing.  The stage stamps and the trainer's waits
are checked on the card (tests/test_torch_cuda.py)."""

import contextlib
import itertools
import tracemalloc

import numpy as np
import pytest
import torch

import fixtures

from beats3d_tpu_torch.data.dataset import ArrayDataset
from beats3d_tpu_torch.models import LayeredDecisionForest
from beats3d_tpu_torch.runtime.app import AppConfig, BeatsApp
from beats3d_tpu_torch.runtime.camera import SyntheticSource
from beats3d_tpu_torch.runtime.midi import Midi
from beats3d_tpu_torch.train import driver
from beats3d_tpu_torch.utils import CameraIntrinsics, profiler

# a live tick's spans, child -> parent (BeatsApp.tick, pipelined; the
# calibrating tick has no fetch)
TICK_NESTING = {"tick": None, "upload": "tick", "plane calibration": "tick",
                "fetch": "tick", "frame_step": "tick", "host update": "tick",
                "wait": "host update", "taps": "host update"}
TRAIN_NESTING = {"train.tree": None, "train.level": "train.tree",
                 "train.histogram": "train.level",
                 "train.gains": "train.level", "finalize": "train.level",
                 "train.advance": "train.level", "train.score": "train.tree"}
# where the trainer waits: the blocks' upload, each level's inputs, the
# histograms, finalize's copies, the advance and the scoring
SYNC_PARENTS = {"train.tree", "train.level", "train.histogram", "finalize",
                "train.advance", "train.score"}


def _tick_spans(timer):
    with timer.span("tick"):
        with timer.span("upload"):
            pass
        with timer.span("frame_step"):
            pass
        with timer.span("host update"):
            with timer.span("wait"):
                pass
            with timer.span("taps"):
                pass


def test_timer_memory_is_bounded_by_its_names():
    timer = profiler.ProfileTimer()
    for _ in range(1000):
        _tick_spans(timer)
    tracemalloc.start()
    try:
        start = tracemalloc.take_snapshot()
        for _ in range(100_000):
            _tick_spans(timer)
        grown = tracemalloc.take_snapshot().compare_to(start, "filename")
    finally:
        tracemalloc.stop()
    mine = sum(d.size_diff for d in grown
               if d.traceback[0].filename == profiler.__file__)
    assert mine < 1024
    assert [n for n, _ in timer.spans()] == [
        "tick", "upload", "frame_step", "host update", "wait", "taps"]
    assert {n: timer.count(n) for n, _ in timer.spans()} == dict.fromkeys(
        ["tick", "upload", "frame_step", "host update", "wait", "taps"],
        101_000)


def test_span_totals_are_the_sum_of_the_spans(monkeypatch):
    """With a clock that steps by known amounts, each name's total is the
    sum of its spans, a parent's total covers its children's, a reset
    starts from nothing, and count() counts the closed spans."""
    steps = itertools.count(0, 1000)          # ns: each reading 1 us later
    monkeypatch.setattr(profiler, "_clock", lambda: next(steps))
    timer = profiler.ProfileTimer()
    for _ in range(3):
        _tick_spans(timer)
    got = dict(timer.spans())
    # readings per tick, in order: tick, upload, upload, frame_step,
    # frame_step, host update, wait, wait, taps, taps, host update, tick
    assert got == pytest.approx({"tick": 0.033, "upload": 0.003,
                                 "frame_step": 0.003, "host update": 0.015,
                                 "wait": 0.003, "taps": 0.003})
    assert got["tick"] > got["upload"] + got["frame_step"] + got["host update"]
    assert timer.count("wait") == 3 and timer.count("nothing") == 0
    timer.reset()
    assert timer.spans() == []
    with timer.span("a"):
        pass
    assert timer.spans() == [("a", 0.001)]


def test_no_record_function_while_the_profiler_is_off(monkeypatch):
    entered = []
    real = torch.profiler.record_function

    def counting(name, *a, **k):
        entered.append(name)
        return real(name, *a, **k)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    timer = profiler.ProfileTimer()
    _tick_spans(timer)
    assert entered == []
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        _tick_spans(timer)
    assert entered == ["tick", "upload", "frame_step", "host update", "wait",
                       "taps"]
    _tick_spans(timer)
    assert len(entered) == 6


def _parents(prof, names):
    """{(range, its innermost enclosing range among ``names``)} of the
    profiled ranges named in ``names``."""
    evs = [(e.time_range.start, e.time_range.end, e.name)
           for e in prof.events() if e.name in names]
    out = set()
    for s, t, n in evs:
        around = [(t2 - s2, n2) for s2, t2, n2 in evs
                  if s2 <= s and t <= t2 and (s2, t2, n2) != (s, t, n)]
        out.add((n, min(around)[1] if around else None))
    return out


def _cpu_profile():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


def _app(tmp_path, rng):
    intrin = CameraIntrinsics.d415(212, 120)
    model = LayeredDecisionForest.load(
        fixtures.layered_cfg_fixture(str(tmp_path), rng), labels_reduce=2,
        device="cpu")
    src = SyntheticSource(intrin)
    app = BeatsApp(model, src, midi=Midi(),
                   cfg=AppConfig(plane_num_iterations=64, warmup_frames=1,
                                 group_min_size=0.02),
                   log=lambda *a: None)
    return app, src.frames()


@pytest.mark.parametrize("profiled", [False, True])
def test_tick_and_batch_ranges_nest(tmp_path, rng, profiled):
    """BeatsApp.tick's ranges nest as the tick runs (tick > upload, plane
    calibration, fetch, frame_step, host update > wait, taps), the app's
    timer holds one aggregate per name, and FramePipeline.batch is one
    ``batch`` range; with the profiler off or on, the same outputs."""
    app, frames = _app(tmp_path, rng)
    frames = [next(frames) for _ in range(5)]
    batch = torch.stack([torch.as_tensor(f.depth) for f in frames[:3]])
    with _cpu_profile() if profiled else contextlib.nullcontext() as prof:
        outs = [app.tick(f) for f in frames]
        batched = app.pipeline.batch(batch, app.calibrated_plane.get_mat())
    assert outs[0] is None and outs[1] is None   # warm-up, then pipelined
    names = [n for n, _ in app.timer.spans()]
    assert sorted(names) == sorted(TICK_NESTING)
    assert app.timer.count("tick") == 5 and app.timer.count("fetch") == 3
    if profiled:
        assert _parents(prof, set(TICK_NESTING) | {"batch"}) == {
            (n, p) for n, p in TICK_NESTING.items()} | {("batch", None)}
    # tracing changes nothing: the outputs of a second app without it
    other, _ = _app(tmp_path, np.random.default_rng(1234))
    want = [other.tick(f) for f in frames]
    want_b = other.pipeline.batch(batch, other.calibrated_plane.get_mat())
    for got, ref in zip(outs[2:] + [batched], want[2:] + [want_b]):
        for k in ref:
            a, b = got[k], ref[k]
            if a.is_floating_point():
                a, b = a.nan_to_num(), b.nan_to_num()
            assert torch.equal(a, b), k


def test_train_forest_ranges_nest(rng):
    """train_forest's ranges under the profiler: train.tree > train.level
    (> train.histogram, train.gains, finalize, train.advance) and
    train.score; each train.sync inside one of those; the trees the same
    bytes as an untraced run's."""
    depth, labels = fixtures.synthetic_hand_dataset(rng, n=6, h=16, w=24)
    kw = dict(num_random_features=16, proposals_per_block=8,
              images_per_block=2, max_tree_depth=4, trees_in_forest=1,
              trees_to_try=2, log=lambda *a: None, device="cpu")

    def train():
        return driver.train_forest(
            ArrayDataset(depth[:4], labels[:4], 4, images_per_block=2),
            ArrayDataset(depth[4:], labels[4:], 4),
            rng=np.random.default_rng(3), **kw)

    syncs = profiler.TIMER.count("train.sync")
    with _cpu_profile() as prof:
        traced = train()
    waits = profiler.TIMER.count("train.sync") - syncs
    got = _parents(prof, set(TRAIN_NESTING) | {"train.sync"})
    # the forest's scoring after the last tree is a train.score of its own
    assert {(n, p) for n, p in got if n != "train.sync"} == set(
        TRAIN_NESTING.items()) | {("train.score", None)}
    sync_parents = {p for n, p in got if n == "train.sync"}
    assert sync_parents <= SYNC_PARENTS and "train.histogram" in sync_parents
    assert sum(e.name == "train.sync" for e in prof.events()) == waits > 0
    assert train().data.tobytes() == traced.data.tobytes()
    # the same tree makes the same waits
    assert profiler.TIMER.count("train.sync") - syncs == 2 * waits
