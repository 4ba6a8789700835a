"""The traced window of a run: torch.profiler over a fixed number of calls,
its chrome trace written under the temporary directory, read by the frozen
parser (``devtime``) and deleted.

Returns the device's busy seconds (the union over its streams) and the
window's wall seconds, per-op and per-stage device time, the host ranges
by name, and the breakdown the result line carries: the device operations
that took most time and the longest idle stretches of the device, each
named by what the host was doing meanwhile (the innermost host operation
or range that covers it, else "host: python").
"""

from __future__ import annotations

import heapq
import os
import time

import torch

from . import devtime

HOST_CATEGORIES = ("cpu_op", "user_annotation", "cuda_runtime",
                   "cuda_driver")
TOP = 10


def _host_spans(events):
    """(start_ns, end_ns, name, cat) of the host's complete events, without
    the profiler's own step ranges."""
    out = []
    for ev in events:
        if ev.get("ph") != "X" or ev.get("cat") not in HOST_CATEGORIES:
            continue
        if ev["name"].startswith("ProfilerStep"):
            continue
        st = devtime.ns(ev["ts"])
        out.append((st, st + devtime.ns(ev["dur"]), ev["name"], ev["cat"]))
    return out


def _step_window(events):
    """(start_ns, end_ns) of the traced step (the active ``ProfilerStep#``
    range on the host), or None."""
    steps = [(devtime.ns(e["ts"]), devtime.ns(e["ts"]) + devtime.ns(e["dur"]))
             for e in events if e.get("ph") == "X"
             and e.get("cat") == "user_annotation"
             and e.get("name", "").startswith("ProfilerStep")]
    return max(steps) if steps else None


def idle_gaps(dev_evs, host, window):
    """{host name: idle ns}: each stretch of the window in which no device
    event runs, named by the innermost host span over its midpoint."""
    lo, hi = window
    busy = [(max(a, lo), min(b, hi)) for a, b in
            devtime.union_intervals([(s, e) for _, _, s, e, _ in dev_evs])
            if b > lo and a < hi]
    gaps, cur = [], lo
    for a, b in busy:
        if a > cur:
            gaps.append((cur, a))
        cur = max(cur, b)
    if hi > cur:
        gaps.append((cur, hi))
    # sweep the gaps' midpoints in order; a heap of the host spans begun
    # so far, shortest first, gives the innermost one still open
    host = sorted(host)
    out, heap, j = {}, [], 0
    for a, b in sorted(gaps, key=lambda g: (g[0] + g[1]) // 2):
        mid = (a + b) // 2
        while j < len(host) and host[j][0] <= mid:
            s, e, n, _ = host[j]
            heapq.heappush(heap, (e - s, e, n))
            j += 1
        while heap and heap[0][1] < mid:
            heapq.heappop(heap)
        name = "host: " + heap[0][2][:150] if heap else "host: python"
        out[name] = out.get(name, 0) + (b - a)
    return out


def traced(call, n: int, tmpdir: str, sync=torch.cuda.synchronize):
    """Trace ``n`` calls of ``call()`` after one traced warm-up call that
    is dropped (without it CUPTI can lose a window's first records).
    Returns the dict described in the module docstring, with ``calls`` =
    n."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    sched = torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)
    with torch.profiler.profile(activities=acts, schedule=sched) as prof:
        call()
        sync()
        prof.step()
        t0 = time.perf_counter()
        for _ in range(n):
            call()
        sync()
        wall = time.perf_counter() - t0
        prof.step()
    return read(prof, wall, tmpdir, calls=n)


def read(prof, wall: float, tmpdir: str, calls: int = 1):
    """Read a finished profiler's trace (see the module docstring)."""
    path = os.path.join(tmpdir, f"portbench_trace_{os.getpid()}.json")
    prof.export_chrome_trace(path)
    try:
        events = devtime.load_events(path)
    finally:
        os.remove(path)
    dev_evs = devtime.device_events(events)
    if not dev_evs:
        raise RuntimeError("the traced window holds no device event")
    busy_ms, per_op, stages = devtime.tables(dev_evs)
    host = _host_spans(events)
    window = _step_window(events) or (min(e[2] for e in dev_evs),
                                      max(e[3] for e in dev_evs))
    gaps = idle_gaps(dev_evs, host, window)
    ranges = {}
    for s, e, name, cat in host:
        if cat == "user_annotation":
            r = ranges.setdefault(name, [0.0, 0])
            r[0] += (e - s) / 1e9
            r[1] += 1
    ops = sorted(((ms / 1e3, name) for name, (ms, _) in per_op.items()),
                 reverse=True)[:TOP]
    idle = sorted(((v / 1e9, k) for k, v in gaps.items()), reverse=True)[:TOP]
    return dict(
        calls=calls, busy_s=busy_ms / 1e3, window_s=wall,
        per_op=per_op, stages=stages, ranges=ranges,
        breakdown=dict(device_ops=[[n[:200], s] for s, n in ops],
                       idle_gaps=[[n[:200], s] for s, n in idle]))
