# ProfileTimer and FrameTimeLog are copied from beats3d_tpu/utils/profiler.py.
"""Host-side span profiler (reference src/engine/profile_timer.py:3-27), a
frame-time ring buffer (reference engine/window.py:150-155), and the device
timer of the port's kernels (:func:`graph_ms`)."""

from __future__ import annotations

import collections
import time
from typing import List, Tuple

import torch


class ProfileTimer:
    """Named wall-clock spans: record(name) starts a span ending at the next
    record()/stop(); render() returns per-span milliseconds + total."""

    def __init__(self):
        self.events: List[Tuple[str, float]] = []

    def reset(self):
        self.events = []

    def record(self, name: str):
        self.events.append((name, time.perf_counter()))

    def stop(self):
        self.events.append(("__stop__", time.perf_counter()))

    def spans(self) -> List[Tuple[str, float]]:
        out = []
        for (name, t0), (_, t1) in zip(self.events, self.events[1:]):
            out.append((name, (t1 - t0) * 1000.0))
        return out

    def render(self) -> List[str]:
        spans = self.spans()
        total = sum(ms for _, ms in spans)
        lines = [f"{name}: {ms:.2f} ms" for name, ms in spans]
        lines.append(f"total: {total:.2f} ms")
        self.reset()
        return lines


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
