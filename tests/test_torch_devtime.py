"""beats3d_tpu_torch.utils.devtime against beats3d_tpu.utils.devtime: the
same device events, written as a jax.profiler ``.xplane.pb`` and as a
torch.profiler (kineto) chrome trace, give the same busy time, per-op and
per-stage tables on one stream; on several streams the port's busy time is
the union over a device's streams (a plain numpy union); the port's
departures (the union, partial overlaps on a stream, no None on the card)
hold; and the stage table places every kernel of the port's CUDA sources.
"""

import json
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beats3d_tpu.utils import devtime as jax_devtime
from beats3d_tpu_torch.utils import devtime


CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "beats3d_tpu_torch", "csrc")
REL = 1e-9      # JAX divides ps by 1e9, the port ns by 1e6

# Names that both modules' STAGES place alike (asserted below), one or more
# per stage and "other": XLA op names and the port's kernels as the card's
# trace names them.
NAMES = (
    "void (anonymous namespace)::evaluate_layered_kernel<4, 1, 8>(int "
    "const*, int*, int, int, int, float, (anonymous namespace)::"
    "LayeredParams, int const*, int)",
    "custom-call.3", "pallas_call", "tree_eval.1",
    "void (anonymous namespace)::plane_band_gauss_kernel<true>(int const*, "
    "int*, int, int, float const*, (anonymous namespace)::BandParams)",
    "shrink.2", "deproject",
    "void (anonymous namespace)::hand_groups_kernel<true>(int const*, long "
    "long, long long, long long, int, int, float const*, long*, int*)",
    "while.7", "label_components",
    "crop_mm", "scatter.4", "dynamic-update-slice.1",
    "mean_shift_step", "meanshift.2",
    "reduce.11", "convert.3", "select.9", "compare.2",
    "fusion.12", "copy.5", "transpose.1", "bitcast.2",
    "(anonymous namespace)::set_branch_kernel(unsigned long long, unsigned "
    "long long, bool const*, long long*)",
    "sort.1", "rng-bit-generator",
)


def jax_stage(name):
    key = name.split(" = ")[0] + " " + name.split(" = ")[-1][:40]
    for sname, pat in jax_devtime.STAGES:
        if re.search(pat, key, re.I):
            return sname
    return "other"


def write_xplane(path, planes):
    """planes: {device: {stream: [(start_ns, end_ns, name)]}} as a JAX
    ``.xplane.pb`` (one plane ``/device:GPU:<device>`` per device, one line
    per stream, times in ps)."""
    xplane_pb2 = pytest.importorskip(
        "tensorflow.tsl.profiler.protobuf.xplane_pb2")
    space = xplane_pb2.XSpace()
    for dev, streams in planes.items():
        plane = space.planes.add(id=dev, name=f"/device:GPU:{dev}")
        ids = {}
        for stream, events in streams.items():
            line = plane.lines.add(id=stream, name=f"Stream #{stream}")
            for st, en, name in events:
                mid = ids.setdefault(name, len(ids) + 1)
                plane.event_metadata[mid].id = mid
                plane.event_metadata[mid].name = name
                line.events.add(metadata_id=mid, offset_ps=st * 1000,
                                duration_ps=(en - st) * 1000)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        f.write(space.SerializeToString())


def us(ns):
    """Kineto's text for a time in ns: us with three decimals."""
    return f"{ns // 1000}.{ns % 1000:03d}"


def write_chrome(path, planes, extra=(), cat="kernel"):
    """The same events as kineto writes them (``ts``/``dur`` in us with
    ns decimals, device and stream in args), plus ``extra`` events."""
    events = []
    for dev, streams in planes.items():
        for stream, evs in streams.items():
            for st, en, name in evs:
                events.append(
                    f'{{"ph": "X", "cat": "{cat}", "name": {json.dumps(name)},'
                    f' "pid": {dev}, "tid": {stream}, "ts": {us(st)}, '
                    f'"dur": {us(en - st)}, "args": {{"device": {dev}, '
                    f'"stream": {stream}, "correlation": 1}}}}')
    events += [json.dumps(e) for e in extra]
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write('{"schemaVersion": 1, "traceEvents": [\n'
                + ",\n".join(events) + "\n]}")


def nested_line(rng, n_top=40, t0=10 ** 9):
    """One stream's events on integer ns: top-level events disjoint or
    touching, some holding nested children (themselves disjoint, touching
    or nesting again), names from NAMES."""
    out, t = [], t0

    def span(st, en, depth):
        out.append((st, en, NAMES[rng.integers(len(NAMES))]))
        if depth < 2 and en - st > 40 and rng.random() < 0.4:
            c = st + int(rng.integers(1, 10))
            while c < en - 10 and rng.random() < 0.8:
                ce = min(en, c + int(rng.integers(5, max(6, (en - st) // 2))))
                span(c, ce, depth + 1)
                c = ce + int(rng.integers(0, 3))   # 0: touching

    for _ in range(n_top):
        en = t + int(rng.integers(1, 5000))
        span(t, en, 0)
        t = en + int(rng.choice([0, 0, 1, int(rng.integers(1, 3000))]))
    return out


def numpy_union_ms(planes):
    """Device busy ms: per device, the ns that any stream's event covers,
    summed over devices."""
    total = 0
    for streams in planes.values():
        evs = [e for line in streams.values() for e in line]
        lo = min(st for st, _, _ in evs)
        busy = np.zeros(max(en for _, en, _ in evs) - lo, bool)
        for st, en, _ in evs:
            busy[st - lo:en - lo] = True
        total += int(busy.sum())
    return total / 1e6


def assert_tables_equal(got, want):
    busy, per_op, stages = got
    assert busy == pytest.approx(want[0], rel=REL)
    for a, b in ((per_op, want[1]), (stages, want[2])):
        assert set(a) == set(b)
        for k in a:
            assert a[k][1] == b[k][1], k
            assert a[k][0] == pytest.approx(b[k][0], rel=REL), k


def test_names_are_placed_alike_and_cover_every_stage():
    got = [devtime.stage_of(n) for n in NAMES]
    assert got == [jax_stage(n) for n in NAMES]
    assert set(got) == {s for s, _ in devtime.STAGES} | {"other"}


@pytest.mark.parametrize("seed", range(8))
def test_one_stream_equals_jax(tmp_path, seed):
    rng = np.random.default_rng(seed)
    planes = {0: {7: nested_line(rng)}}
    write_xplane(str(tmp_path / "jax" / "t.xplane.pb"), planes)
    write_chrome(str(tmp_path / "torch" / "t.pt.trace.json"), planes)
    want = jax_devtime.parse_trace(str(tmp_path / "jax"))
    got = devtime.parse_trace(str(tmp_path / "torch"))
    assert_tables_equal(got, want)
    assert got[0] == pytest.approx(numpy_union_ms(planes), rel=REL)
    # the draw holds nesting (events not counted) and touching events
    line = sorted(planes[0][7])
    assert sum(c for _, c in got[1].values()) < len(line)
    assert any(a[1] == b[0] for a, b in zip(line, line[1:]))


@pytest.mark.parametrize("seed", range(3))
def test_streams_and_devices_take_the_union(tmp_path, seed):
    """Concurrent streams: the port's busy time is each device's union over
    its streams (summed over devices), JAX's the largest stream's union;
    per-op tables agree (no stream holds a partial overlap)."""
    rng = np.random.default_rng(100 + seed)
    planes = {d: {s: nested_line(rng, n_top=15,
                                 t0=10 ** 9 + int(rng.integers(0, 20000)))
                  for s in (7, 13, 20)} for d in (0, 1)}
    write_xplane(str(tmp_path / "jax" / "t.xplane.pb"), planes)
    write_chrome(str(tmp_path / "torch" / "t.pt.trace.json"), planes)
    busy, per_op, stages = devtime.parse_trace(str(tmp_path / "torch"))
    jax_busy, jax_per_op, jax_stages = jax_devtime.parse_trace(
        str(tmp_path / "jax"))
    assert busy == pytest.approx(numpy_union_ms(planes), rel=REL)
    assert busy > jax_busy * (1 + 1e-6)
    assert_tables_equal((busy, per_op, stages),
                        (busy, jax_per_op, jax_stages))


def test_partial_overlap_on_a_stream_counts_both(tmp_path):
    """A CUDA graph's consecutive kernels on one stream overlap by tens of
    ns in the trace: the port counts both (JAX drops the first); the busy
    union is the same."""
    k1 = NAMES[0]
    planes = {0: {7: [(1000, 28000, k1), (27968, 29000, "fusion.1"),
                      (29000, 30000, "copy.2")]}}
    write_xplane(str(tmp_path / "jax" / "t.xplane.pb"), planes)
    write_chrome(str(tmp_path / "torch" / "t.pt.trace.json"), planes)
    busy, per_op, stages = devtime.parse_trace(str(tmp_path / "torch"))
    jax_busy, jax_per_op, _ = jax_devtime.parse_trace(str(tmp_path / "jax"))
    assert busy == pytest.approx(jax_busy, rel=REL) == 0.029
    assert per_op[k1] == [pytest.approx(0.027, rel=REL), 1]
    assert k1 not in jax_per_op
    assert stages["eval_kernel"][1] == 1
    assert sum(c for _, c in per_op.values()) == 3


def test_other_categories_add_nothing(tmp_path):
    rng = np.random.default_rng(7)
    planes = {0: {7: nested_line(rng, n_top=10)}}
    write_chrome(str(tmp_path / "plain" / "t.json"), planes)
    t = 10 ** 9
    extra = [
        {"ph": "X", "cat": "gpu_user_annotation", "name": "chip_smoke call",
         "pid": 0, "tid": 7, "ts": us(t - 500), "dur": us(10 ** 6),
         "args": {"device": 0, "stream": 7}},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "pid": 4242,
         "tid": 4242, "ts": us(t), "dur": us(30000)},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaGraphLaunch",
         "pid": 4242, "tid": 4242, "ts": us(t), "dur": us(9000)},
        {"ph": "X", "cat": "python_function", "name": "tick", "pid": 4242,
         "tid": 4242, "ts": us(t), "dur": us(90000)},
        {"ph": "s", "cat": "ac2g", "name": "ac2g", "id": 1, "pid": 4242,
         "tid": 4242, "ts": us(t)},
        {"ph": "f", "cat": "ac2g", "name": "ac2g", "id": 1, "pid": 0,
         "tid": 7, "ts": us(t), "bp": "e"},
        {"ph": "M", "name": "process_name", "pid": 0, "tid": 0,
         "args": {"name": "python"}},
    ]
    write_chrome(str(tmp_path / "mixed" / "t.pt.trace.json"), planes, extra)
    assert_tables_equal(devtime.parse_trace(str(tmp_path / "mixed")),
                        devtime.parse_trace(str(tmp_path / "plain")))


def test_copies_and_sets_count(tmp_path):
    planes = {0: {7: [(0, 1500, "Memcpy HtoD (Pinned -> Device)"),
                      (1500, 2000, "Memcpy DtoH (Device -> Pinned)")]}}
    write_chrome(str(tmp_path / "c" / "a.json"), planes, cat="gpu_memcpy")
    sets = {0: {7: [(5000, 5250, "Memset (Device)")]}}
    write_chrome(str(tmp_path / "s" / "b.json"), sets, cat="gpu_memset")
    busy, per_op, stages = devtime.parse_trace(str(tmp_path / "c"))
    assert busy == pytest.approx(0.002, rel=REL)
    assert stages == {"copy_transfer": [pytest.approx(0.002, rel=REL), 2]}
    busy, per_op, _ = devtime.parse_trace(str(tmp_path / "s"))
    assert per_op == {"Memset (Device)": [pytest.approx(0.00025), 1]}


def test_newest_trace_is_read(tmp_path):
    write_chrome(str(tmp_path / "a" / "old.json"), {0: {7: [(0, 1000, "x")]}})
    write_chrome(str(tmp_path / "b" / "new.pt.trace.json"),
                 {0: {7: [(0, 3000, "y")]}})
    old = str(tmp_path / "a" / "old.json")
    os.utime(old, (1, 1))
    assert devtime.parse_trace(str(tmp_path))[1] == {
        "y": [pytest.approx(0.003), 1]}


def test_missing_and_cpu_only_traces_raise(tmp_path):
    with pytest.raises(FileNotFoundError):
        devtime.parse_trace(str(tmp_path / "none"))
    (tmp_path / "cpu").mkdir()
    with open(tmp_path / "cpu" / "t.json", "w") as f:
        json.dump({"traceEvents": [
            {"ph": "X", "cat": "cpu_op", "name": "aten::mul", "pid": 1,
             "tid": 1, "ts": 5.0, "dur": 2.0},
            {"ph": "X", "cat": "gpu_user_annotation", "name": "r", "pid": 0,
             "tid": 7, "ts": 5.0, "dur": 2.0}]}, f)
    with pytest.raises(RuntimeError, match="cpu_op.*gpu_user_annotation"):
        devtime.parse_trace(str(tmp_path / "cpu"))


def test_measure_device_ms_on_cpu_returns_none(tmp_path):
    calls = []

    def fn():
        calls.append(1)
        return torch.ones(64).sum()

    synced = []
    assert devtime.measure_device_ms(fn, 3, logdir=str(tmp_path / "t"),
                                     sync=synced.append) is None
    assert len(calls) == 4 and len(synced) == 1      # 3 and the warm-up
    assert os.listdir(tmp_path / "t")                # the trace was written
    x = jnp.ones((8, 8))
    assert jax_devtime.measure_device_ms(
        lambda: x @ x, 3, logdir=str(tmp_path / "jax"),
        sync=lambda o: o.block_until_ready()) is None


def test_measure_device_ms_raises_what_fn_raises(tmp_path):
    def fn():
        raise ValueError("no frame")

    with pytest.raises(ValueError, match="no frame"):
        devtime.measure_device_ms(fn, 2, logdir=str(tmp_path / "t"))


def test_stages_extend_jax_patterns():
    assert [s for s, _ in devtime.STAGES] == [s for s, _ in
                                             jax_devtime.STAGES]
    for (_, pat), (_, jax_pat) in zip(devtime.STAGES, jax_devtime.STAGES):
        assert pat == jax_pat or pat.startswith(jax_pat + "|"), pat


# every __global__ kernel of the sources the port's paths launch, by stage
KERNEL_STAGES = {
    "forest_eval.cu": {"evaluate_layered_kernel": "eval_kernel",
                       "evaluate_layered_wide_kernel": "eval_kernel",
                       "evaluate_forest_kernel": "eval_kernel"},
    "train_features.cu": {"train_feature_bits_kernel": "eval_kernel"},
    "preproc.cu": {"plane_band_gauss_kernel": "preproc"},
    "components.cu": {f"hand_groups_{k}": "components" for k in (
        "kernel", "mb_local", "mb_merge", "mb_compress", "mb_select",
        "mb_write")},
    "graph_cond.cu": {"set_branch_kernel": "other"},
}


@pytest.mark.parametrize("source", sorted(KERNEL_STAGES))
def test_every_kernel_lands_in_its_stage(source):
    with open(os.path.join(CSRC, source)) as f:
        text = f.read()
    names = re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)"
                       r"\s*)?(\w+)\s*\(", text)
    assert sorted(names) == sorted(KERNEL_STAGES[source])
    for name in names:
        want = KERNEL_STAGES[source][name]
        # as the source names it, and as the trace does (template, args)
        assert devtime.stage_of(name) == want, name
        traced = (f"void (anonymous namespace)::{name}<true>(int const*, "
                  "int*, int, int, float const*, long long*)")
        assert devtime.stage_of(traced) == want, traced
