# Copied from beats3d_tpu/utils/profiler.py (numpy / host only).
"""Host-side span profiler (reference src/engine/profile_timer.py:3-27) plus a
frame-time ring buffer (reference engine/window.py:150-155)."""

from __future__ import annotations

import collections
import time
from typing import List, Tuple


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
