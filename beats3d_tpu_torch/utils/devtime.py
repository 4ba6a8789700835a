"""Device time from torch.profiler traces: the card's busy time, per-op and
per-stage tables (the counterpart of beats3d_tpu/utils/devtime.py, which
reads the TPU plane of a jax.profiler ``.xplane.pb``).

A trace is the chrome trace torch.profiler (kineto) writes.  Its device
events are the complete events (``"ph": "X"``) of the categories
``kernel``, ``gpu_memcpy`` and ``gpu_memset``; a device (``args.device``,
else ``pid``) plays the xplane's plane and a stream (``args.stream``, else
``tid``) its line.  record_function's device-side spans
(``gpu_user_annotation``), host ops, runtime calls, Python frames and flow
events are not device work.  Kineto writes times as microseconds with the
nanoseconds as three decimals; they are read exactly, as integer ns.

Where this module departs from the JAX one, on purpose:

* ``busy_ms`` is the union of the events of every stream of a device,
  summed over devices.  A TPU plane's lines are views of one execution, so
  JAX takes the largest line's union; CUDA streams run work concurrently
  (the frame graph's cond bodies are captured on streams of their own), so
  the largest stream would miss overlapped work and a sum over streams
  would count it twice.  On one stream the two rules give one number.
* ``per_op`` counts an event unless it wraps the next event of its
  stream (that event starts and ends inside it).  JAX drops any event that
  the next one starts inside: XLA nests while and cond ops over their
  bodies on one line.  A CUDA stream's kernels never nest, but in a CUDA
  graph's replay consecutive kernels of one stream can overlap by tens of
  ns in the trace (the batched frame call on an H100), and JAX's rule
  would drop those kernels, K1 among them.  Nested and touching events
  count as in JAX.
* :func:`measure_device_ms` traces one warm-up call and drops it, and
  synchronises the card before the window closes (reasons at the code).
* :func:`measure_device_ms` returns None only when the trace holds no
  device event, as on a CPU run; every other failure raises.  JAX's
  version returns None on any exception, which hides the device.

Kernel names are the profiler's.  In a process that has dropped CUDA
graphs, the kernels that a later graph runs in a conditional node's body
can carry other kernels' names (on an H100, after chip_smoke.py's
earlier phases: 12 records named K1 in a window of 6 replays that launch
it once each): their times, and so ``busy_ms``, stay right; ``per_op``
and ``stages`` are right in a process whose graphs all still live.

Shared by the port's callers that need the card's own time rather than the
host's: ``chip_smoke.py`` devtime_path, and the port's bench lane.
"""

import glob
import json
import os
import re
import shutil
import tempfile
import time
from decimal import Decimal

import torch

# Stage attribution: first matching pattern wins.  Each pattern is the JAX
# module's (XLA op names) followed by the port's names for the same work,
# as a main_path trace on the card names them:
#   eval_kernel   + evaluate_forest (B1; in JAX a pallas_call),
#                   train_feature_bits (B4); K1 (evaluate_layered_kernel,
#                   evaluate_layered_wide_kernel) is "layered" already
#   preproc         K2 (plane_band_gauss_kernel) is "plane_band" already
#   components      hand_groups_kernel, hand_groups_mb_* are "hand_group"
#   crop_scatter  + the hand-image and label kernels (csrc/hand_images.cu:
#                   stencil_hand_images_kernel, stencil_guard_kernel,
#                   place_crop_labels_kernel) and ATen's gathers and index
#                   copies (vectorized_gather_kernel, gpu_index_kernel,
#                   index_copy_kernel_impl; _scatter_gather_* is "scatter")
#   reduce_misc     ATen's reductions are reduce_kernel (sum, max, min, or,
#                   argmax), its comparisons CompareEq/compare_scalar
#   fusion_other  + ATen's elementwise kernels ({vectorized_,unrolled_,
#                   index_}elementwise_kernel), in XLA's fusions' place
#   copy_transfer + the copies and sets (Memcpy HtoD/DtoH/DtoD events,
#                   memcpy* kernels; CatArrayBatchedCopy* is "copy")
#   meanshift       the mean-shift kernel (mean_shift_kernel, csrc/
#                   mean_shift.cu; the ATen ops around it are not)
# set_branch_kernel (csrc/graph_cond.cu) sets a conditional node: XLA's
# conditional wraps its body and is never a leaf, so it stays "other", as
# does ATen's sort (bitonicSortKVInPlace; XLA's sort is "other" too).
STAGES = (
    ("eval_kernel", r"forest_eval|layered|pallas_call|tree_|custom-call"
                    r"|evaluate_forest|train_feature_bits"),
    ("preproc", r"plane_band|gauss|preproc|deproject|shrink"),
    ("components", r"components|label_comp|hand_group|while"),
    ("crop_scatter", r"crop|scatter|stencil|dynamic_update|dynamic-update"
                     r"|gather|index_kernel|index_copy"),
    ("meanshift", r"mean_shift|meanshift"),
    ("reduce_misc", r"reduce|convert|select|broadcast|iota|compare"),
    ("fusion_other", r"fusion|elementwise_kernel"),
    ("copy_transfer", r"copy|transpose|bitcast|memcpy|memset"),
)

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def stage_of(name):
    """The STAGES name of a device event's name, or "other"; matched as
    the JAX module matches an op name (its ``lhs = rhs`` form read as the
    lhs and the rhs's first 40 characters)."""
    key = name.split(" = ")[0] + " " + name.split(" = ")[-1][:40]
    for sname, pat in STAGES:
        if re.search(pat, key, re.I):
            return sname
    return "other"


def newest_trace(logdir):
    """The newest chrome trace (``*.json``: ``*.pt.trace.json`` from
    ``tensorboard_trace_handler``, any name from ``export_chrome_trace``)
    under ``logdir``, searched recursively."""
    paths = sorted(glob.glob(os.path.join(logdir, "**", "*.json"),
                             recursive=True), key=os.path.getmtime)
    if not paths:
        raise FileNotFoundError(f"no chrome trace (*.json) under {logdir}")
    return paths[-1]


def _ns(t):
    """A kineto time (us, three decimals, read as text) in integer ns."""
    return int((Decimal(str(t)) * 1000).to_integral_value())


def device_events(path):
    """(device, stream, start_ns, end_ns, name) of every device event of
    the chrome trace at ``path``, and the sorted categories the trace
    holds."""
    with open(path) as f:
        events = json.load(f, parse_float=str)["traceEvents"]
    out, cats = [], set()
    for ev in events:
        cat = ev.get("cat")
        if cat is not None:
            cats.add(cat)
        if ev.get("ph") != "X" or cat not in DEVICE_CATEGORIES:
            continue
        args = ev.get("args", {})
        start = _ns(ev["ts"])
        out.append((args.get("device", ev["pid"]),
                    args.get("stream", ev["tid"]),
                    start, start + _ns(ev["dur"]), ev["name"]))
    return out, sorted(cats)


def _union_ns(intervals):
    """Length of the union of sorted (start, end, ...) intervals; an
    interval that starts where the last ended joins it."""
    total = 0
    cur_s, cur_e = intervals[0][0], intervals[0][1]
    for st, en, *_ in intervals[1:]:
        if st > cur_e:
            total += cur_e - cur_s
            cur_s, cur_e = st, en
        else:
            cur_e = max(cur_e, en)
    return total + cur_e - cur_s


def tables(evs):
    """(busy_ms, per_op, stages) of :func:`device_events`' events: see
    :func:`parse_trace`."""
    by_device, by_stream = {}, {}
    for dev, stream, st, en, name in evs:
        by_device.setdefault(dev, []).append((st, en, name))
        by_stream.setdefault((dev, stream), []).append((st, en, name))

    per_op = {}
    for line in by_stream.values():
        line.sort()
        for i, (st, en, name) in enumerate(line):
            # a wrapper holds the next event of its line (see the module
            # docstring: JAX drops any event the next one starts inside)
            if not (i + 1 < len(line) and line[i + 1][0] < en
                    and line[i + 1][1] <= en):
                agg = per_op.setdefault(name, [0.0, 0])
                agg[0] += (en - st) / 1e6
                agg[1] += 1
    busy_ms = sum(_union_ns(sorted(d)) / 1e6 for d in by_device.values())

    stages = {}
    for name, (ms, cnt) in per_op.items():
        s = stages.setdefault(stage_of(name), [0.0, 0])
        s[0] += ms
        s[1] += cnt
    return busy_ms, per_op, stages


def parse_trace(logdir):
    """Parse the newest chrome trace under ``logdir``.

    Returns (busy_ms, per_op, stages): busy_ms is the union of the device
    events of all streams of a device, summed over devices; per_op maps
    event name -> [ms, count] over the leaf events of each stream (an
    event that holds the next one of its stream is not a leaf); stages
    aggregates per_op through STAGES."""
    evs, cats = device_events(newest_trace(logdir))
    if not evs:
        raise RuntimeError("no device event (kernel, gpu_memcpy, "
                           f"gpu_memset) in trace; categories: {cats}")
    return tables(evs)


def measure_device_ms(fn, iters, logdir=None, sync=None):
    """Trace ``iters`` calls of ``fn`` and return per-iteration device
    metrics: {"device_ms": busy/iters, "stages": {name: ms/iter},
    "wall_ms": host wall per iter, from before the first call to after
    ``sync(out)`` of the last call's output}.  ``logdir`` (cleared first;
    default ``<tmp>/b3d_devtime``) receives the trace.  Returns None when
    the trace holds no device event: the CPU, or an ``fn`` that launched
    no device work.  Anything else that fails raises."""
    if logdir is None:
        logdir = os.path.join(tempfile.gettempdir(), "b3d_devtime")
    shutil.rmtree(logdir, ignore_errors=True)
    os.makedirs(logdir)
    cuda = torch.cuda.is_available()
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    # (a) the schedule traces one warm-up call and drops it: without a
    # warm-up step CUPTI can lose a window's first kernel record
    sched = torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)
    with torch.profiler.profile(activities=acts, schedule=sched) as prof:
        fn()
        if cuda:
            torch.cuda.synchronize()
        prof.step()
        t0 = time.perf_counter()
        out = None
        for _ in range(iters):
            out = fn()
        if sync is not None:
            sync(out)
        wall = (time.perf_counter() - t0) / iters
        # (b) the wall is JAX's (``sync`` alone ends it); the window closes
        # only once the card has run every kernel the calls launched
        if cuda:
            torch.cuda.synchronize()
        prof.step()
    path = os.path.join(logdir, "devtime.pt.trace.json")
    prof.export_chrome_trace(path)
    # (c) no device event is the CPU's answer; a failure above has raised
    evs, _ = device_events(path)
    if not evs:
        return None
    busy_ms, _, stages = tables(evs)
    return {
        "device_ms": busy_ms / iters,
        "wall_ms": wall * 1e3,
        "stages": {k: v[0] / iters for k, v in stages.items()},
    }
