"""Device time from a torch.profiler chrome trace: the busy union over a
device's streams, per-op [ms, count] and the stage table.

A frozen copy of beats3d_tpu_torch/utils/devtime.py's parser (checked
against ``key_averages`` on the H100), so that the benchmark's arithmetic
does not change with the program.  Device events are the complete events
of the categories ``kernel``, ``gpu_memcpy`` and ``gpu_memset``; a device
is ``args.device`` (else ``pid``), a stream ``args.stream`` (else
``tid``).  Times are read exactly, as integer ns.  An event that wraps
the next event of its stream is not a leaf and is not counted per op (in
a CUDA graph's replay consecutive kernels of one stream can overlap by
tens of ns, and those still count).
"""

import json
import re
from decimal import Decimal

# Stage attribution, first match wins (the port's names after XLA's).
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
    """The STAGES name of a device event's name, or "other"."""
    key = name.split(" = ")[0] + " " + name.split(" = ")[-1][:40]
    for sname, pat in STAGES:
        if re.search(pat, key, re.I):
            return sname
    return "other"


def ns(t):
    """A kineto time (us, three decimals, read as text) in integer ns."""
    return int((Decimal(str(t)) * 1000).to_integral_value())


def load_events(path):
    """Every event of the chrome trace at ``path``, floats kept as text."""
    with open(path) as f:
        return json.load(f, parse_float=str)["traceEvents"]


def device_events(events):
    """(device, stream, start_ns, end_ns, name) of the device events."""
    out = []
    for ev in events:
        if ev.get("ph") != "X" or ev.get("cat") not in DEVICE_CATEGORIES:
            continue
        args = ev.get("args", {})
        start = ns(ev["ts"])
        out.append((args.get("device", ev["pid"]),
                    args.get("stream", ev["tid"]),
                    start, start + ns(ev["dur"]), ev["name"]))
    return out


def union_intervals(intervals):
    """Sorted (start, end) intervals -> their union as disjoint (start,
    end) pairs; an interval that starts where the last ended joins it."""
    out = []
    for st, en, *_ in sorted(intervals):
        if out and st <= out[-1][1]:
            out[-1][1] = max(out[-1][1], en)
        else:
            out.append([st, en])
    return out


def tables(evs):
    """(busy_ms, per_op, stages): the union of each device's events summed
    over devices; name -> [ms, count] over leaf events; stage -> [ms,
    count]."""
    by_device, by_stream = {}, {}
    for dev, stream, st, en, name in evs:
        by_device.setdefault(dev, []).append((st, en))
        by_stream.setdefault((dev, stream), []).append((st, en, name))
    per_op = {}
    for line in by_stream.values():
        line.sort()
        for i, (st, en, name) in enumerate(line):
            if not (i + 1 < len(line) and line[i + 1][0] < en
                    and line[i + 1][1] <= en):
                agg = per_op.setdefault(name, [0.0, 0])
                agg[0] += (en - st) / 1e6
                agg[1] += 1
    busy_ms = sum(sum(b - a for a, b in union_intervals(d)) / 1e6
                  for d in by_device.values())
    stages = {}
    for name, (ms, cnt) in per_op.items():
        s = stages.setdefault(stage_of(name), [0.0, 0])
        s[0] += ms
        s[1] += cnt
    return busy_ms, per_op, stages
