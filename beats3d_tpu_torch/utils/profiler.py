# FrameTimeLog is copied from beats3d_tpu/utils/profiler.py.
"""The port's tracer and its device timers.

* :class:`ProfileTimer`: named, nested host spans (the reference's
  src/engine/profile_timer.py:3-27 made nestable), kept as per-name
  aggregates.  While ``torch.profiler`` records, each span is also a
  ``record_function`` range, on the device trace's own clock.
  :data:`TIMER` is the timer of code that has no app: the frame pipeline
  and the trainer.
* Stage stamps (:class:`StageClock`, :func:`stage_ms`): the device time of
  each stage of a captured frame program, summed on the card
  (``csrc/stage_clock.cu``) into a process-wide registry.
* Routing counters (:class:`RoutingCounts`, :func:`counters`): per layer of
  a routed layered model, the pixels and warp tasks that walked it, added
  by K1 on the card (or by its plain version) into a process-wide
  registry.
* :class:`FrameTimeLog`: a frame-time ring buffer (reference
  engine/window.py:150-155).
* :func:`graph_ms`, :func:`host_ms`: the device timers of the port's
  kernels.
"""

from __future__ import annotations

import collections
import time
from typing import Dict, List, Optional, Tuple

import torch

# the check record_function itself makes: a C call, ~0.1 us
_profiling = torch._C._autograd._profiler_enabled
_clock = time.perf_counter_ns


class _Span:
    """One open span of a :class:`ProfileTimer` (its ``with`` block)."""

    __slots__ = ("_row", "_name", "_t0", "_range")

    def __init__(self, row, name):
        self._row = row
        self._name = name

    def __enter__(self):
        self._range = None
        if _profiling():
            self._range = torch.profiler.record_function(self._name)
            self._range.__enter__()
        self._t0 = _clock()
        return self

    def __exit__(self, *exc):
        self._row[0] += 1
        self._row[1] += _clock() - self._t0
        if self._range is not None:
            self._range.__exit__(*exc)
        return False


class ProfileTimer:
    """Named wall-clock spans, ``with timer.span(name): ...``, nested as
    the blocks nest (a parent's span covers its children's).  Each name
    keeps one aggregate, its count and total time, so the timer's memory
    grows with the names, not with the spans.  While ``torch.profiler``
    records, a span also enters ``torch.profiler.record_function(name)``;
    otherwise it enters none.  One thread uses a timer at a time."""

    def __init__(self):
        self._totals: Dict[str, List[int]] = {}   # name -> [count, ns]

    def span(self, name: str) -> _Span:
        row = self._totals.get(name)
        if row is None:
            row = self._totals[name] = [0, 0]
        return _Span(row, name)

    def reset(self):
        """Drop every aggregate (a span open now is not counted)."""
        self._totals = {}

    def spans(self) -> List[Tuple[str, float]]:
        """(name, total ms) of each name, in the order first seen."""
        return [(name, ns / 1e6) for name, (_, ns) in self._totals.items()]

    def count(self, name: str) -> int:
        """How many spans named ``name`` have closed."""
        row = self._totals.get(name)
        return row[0] if row else 0


TIMER = ProfileTimer()


# -- stage stamps --------------------------------------------------------------

MAX_STAGES = 8          # stages per program
# program -> its stage names, in the order first stamped; (program, device)
# -> int64 (MAX_STAGES + 1,) on the card: ns per stage, then replays
_STAGE_NAMES: Dict[str, List[str]] = {}
_STAGE_ACC: Dict[Tuple[str, torch.device], torch.Tensor] = {}


class StageClock:
    """The stage stamps of one frame graph being captured.  :meth:`stamp`
    captures one launch of ``csrc/stage_clock.cu``'s one-thread kernel on
    the current stream: at each replay it adds the time since the previous
    stamp to the stage that stamp opened, in the accumulator that every
    graph of ``program`` on the card shares (the registry, which outlives
    the graphs and their pipelines).  Make the clock before the capture
    (its tensors must not be the capture's) and keep it as long as the
    graph: each replay writes its ``clock``."""

    def __init__(self, program: str, device):
        device = torch.device(device)
        key = (program, device)
        if key not in _STAGE_ACC:
            _STAGE_ACC[key] = torch.zeros(MAX_STAGES + 1, dtype=torch.int64,
                                          device=device)
        self.acc = _STAGE_ACC[key]
        self.names = _STAGE_NAMES.setdefault(program, [])
        # the replay's last stamp: (time, the stage it opened)
        self.clock = torch.full((2,), -1, dtype=torch.int64, device=device)
        self._first = True

    def stamp(self, name: Optional[str]):
        """``name`` starts here (None: the replay ends here)."""
        from ..ops import cuda_lib

        opening = -1
        if name is not None:
            if name not in self.names:
                if len(self.names) == MAX_STAGES:
                    raise ValueError(f"more than {MAX_STAGES} stages: "
                                     f"{self.names + [name]}")
                self.names.append(name)
            opening = self.names.index(name)
        stream = torch.cuda.current_stream(self.acc.device).cuda_stream
        cuda_lib.check(cuda_lib.library().b3d_stage_stamp(
            stream, self.clock.data_ptr(), self.acc.data_ptr(), opening,
            int(self._first), MAX_STAGES), "stage stamp")
        self._first = False


def stage_ms() -> Dict[str, Dict[str, float]]:
    """{program: {stage: device ms per replay}} over every replay of the
    program's graphs so far, on every card (one host read per card, after
    a synchronise).  A program with no replay is left out."""
    totals: Dict[str, List[int]] = {}
    for (program, device), acc in _STAGE_ACC.items():
        torch.cuda.synchronize(device)
        row = totals.setdefault(program, [0] * (MAX_STAGES + 1))
        for i, v in enumerate(acc.tolist()):
            row[i] += v
    return {program: {name: row[i] / row[MAX_STAGES] / 1e6
                      for i, name in enumerate(_STAGE_NAMES[program])}
            for program, row in totals.items() if row[MAX_STAGES]}


def reset_stages():
    """Zero the registry's accumulators (a window starts here)."""
    for acc in _STAGE_ACC.values():
        acc.zero_()


# -- routing counters ----------------------------------------------------------

COUNT_FIELDS = ("pixels", "tasks", "slots")
# every routed model's counters, in the order the models were built; kept
# for the life of the process (a few hundred bytes each), so that a reader
# after a model is dropped still sees what it counted
_COUNTERS: List["RoutingCounts"] = []


class RoutingCounts:
    """The routing counters of one routed layered model on one device:
    ``acc``, (layers, 3) int64, per layer the pixels that walked it, the
    warp tasks that walked it (a warp's pass over the layer with at least
    one such pixel) and those tasks' pixel slots.  K1 adds to it with one
    atomic per warp and layer, inside a captured graph as outside; the
    plain version adds the same counts from its label images.  ``experts``:
    the sibling layers (two or more filtered on one layer)."""

    def __init__(self, num_layers: int, experts, device):
        self.experts = sorted(int(l) for l in experts)
        self.acc = torch.zeros((num_layers, len(COUNT_FIELDS)),
                               dtype=torch.int64, device=device)
        _COUNTERS.append(self)


def counters() -> List[Dict[str, List[int]]]:
    """One row per routed model that has counted something, in build order:
    {"pixels", "tasks", "slots": per layer, "experts": the sibling layers}
    (one host read per model, after a synchronise)."""
    out = []
    for c in _COUNTERS:
        if c.acc.device.type == "cuda":
            torch.cuda.synchronize(c.acc.device)
        total = c.acc.cpu()
        if not int(total.sum()):
            continue
        row = {f: total[:, i].tolist() for i, f in enumerate(COUNT_FIELDS)}
        row["experts"] = c.experts
        out.append(row)
    return out


def reset_counters():
    """Zero every routing counter (a window starts here)."""
    for c in _COUNTERS:
        c.acc.zero_()


class FrameTimeLog:
    """Ring buffer of per-frame milliseconds (max 100 samples)."""

    def __init__(self, maxlen: int = 100):
        self.log = collections.deque([0.0], maxlen=maxlen)
        self._last = None

    def tick(self):
        now = time.perf_counter()
        if self._last is not None:
            self.log.append((now - self._last) * 1000.0)
        self._last = now

    @property
    def last_ms(self) -> float:
        return self.log[-1]


def graph_ms(fn, iters: int = 20, warmup: int = 2) -> float:
    """Mean device time of fn() per call, in ms.  ``iters`` calls are
    captured in one CUDA graph, replayed once to warm it, then replayed
    between two CUDA events.  A kernel of the port runs for about as long as
    the host takes to launch it (~10-20 us), so timing launches from the
    host times the host; inside a graph the launches follow each other on
    the card.  fn must launch work on the current stream only (no host
    sync)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    graph.replay()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def host_ms(fn, iters: int = 5, warmup: int = 1) -> float:
    """Mean time per call of fn() launched from the host, between two CUDA
    events: what the plain versions (chains of small PyTorch kernels, some
    with host syncs) are timed with."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters
