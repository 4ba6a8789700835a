"""The probe ports (beats3d_tpu_torch/probes) against the scripts/ Mosaic
probes they port, on the CPU: the port's wrapper with CPU tensors (its plain
version) against each script's own ``run`` with ``pallas_call`` in interpret
mode, on the same seeded inputs.  Every path is integer or IEEE-exact
float32, so the outputs must be equal.

Two references cannot run and are held otherwise: prim_bench's serve_trip
raises while it traces (prim_bench.py:103 slices a loaded value with
``pl.ds``), so it is held against a numpy transcription of
prim_bench.py:68-127 that reads that line as the dynamic slice of rows
``[q_al, q_al + 24)``; prim_bench's mm_* raise (prim_bench.py:132), and the
port must raise too.
"""

import functools
import importlib.util
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as jpl

from beats3d_tpu_torch.probes import (prim_bench, repro_roll24, try_axis0,
                                      try_batchmin, try_dyngrid, try_loopcost,
                                      try_loopcost2, try_opcost, try_reduce,
                                      try_vgather)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUB, LANE = 8, 128


@pytest.fixture(scope="module")
def load_script(tmp_path_factory):
    """Import scripts/<name>.py once per test module.  Three scripts turn on
    JAX's persistent compilation cache when imported: point it at a
    temporary directory, then restore the JAX settings, the environment and
    sys.path, so no test leaves a setting or a file behind."""
    loaded = {}

    def load(name):
        if name not in loaded:
            saved = (jax.config.jax_compilation_cache_dir,
                     jax.config.jax_persistent_cache_min_compile_time_secs,
                     os.environ.get("BEATS3D_COMPILE_CACHE"), list(sys.path))
            os.environ["BEATS3D_COMPILE_CACHE"] = str(
                tmp_path_factory.mktemp("compile_cache"))
            try:
                spec = importlib.util.spec_from_file_location(
                    f"_probe_script_{name}",
                    os.path.join(ROOT, "scripts", f"{name}.py"))
                mod = importlib.util.module_from_spec(spec)
                spec.loader.exec_module(mod)
            finally:
                jax.config.update("jax_compilation_cache_dir", saved[0])
                jax.config.update(
                    "jax_persistent_cache_min_compile_time_secs", saved[1])
                if saved[2] is None:
                    os.environ.pop("BEATS3D_COMPILE_CACHE", None)
                else:
                    os.environ["BEATS3D_COMPILE_CACHE"] = saved[2]
                sys.path[:] = saved[3]
            loaded[name] = mod
        return loaded[name]

    return load


@pytest.fixture
def interpret(monkeypatch):
    """pallas_call in interpret mode, as the JAX package's CPU tests run
    their kernels."""
    monkeypatch.setattr(jpl, "pallas_call",
                        functools.partial(jpl.pallas_call, interpret=True))


def _rng(*key):
    return np.random.default_rng([20261016, *key])


def _tiles(rng, nt, lo, hi):
    return rng.integers(lo, hi, (nt, SUB, LANE)).astype(np.int32)


WIDE = (-(1 << 31), 1 << 31)   # every int32: sums wrap


def _port(fn, *args, **kw):
    """fn on CPU tensors of the numpy arrays in args."""
    return fn(*[torch.as_tensor(a) if isinstance(a, np.ndarray) else a
                for a in args], **kw).numpy()


def _equal(got, want):
    np.testing.assert_array_equal(got, np.asarray(want))


# --------------------------------------------------------------- P11 opcost

# fmath divides by float(x) + 5: it takes the script's x >= 0 only
@pytest.mark.parametrize("op,data", [(op, "script") for op in try_opcost.OPS]
                         + [(op, "wide") for op in try_opcost.OPS
                            if op != "fmath"])
def test_opcost_matches_script(load_script, interpret, op, data):
    ref = load_script("try_opcost")
    rng = _rng(11, try_opcost.OPS.index(op))
    x = _tiles(rng, 3, *((0, 100) if data == "script" else WIDE))
    idx = _tiles(rng, 3, 0, LANE)
    for k in (1, 2, 6):
        want = ref.run(jnp.asarray(x), jnp.asarray(idx), op=op, k=k)
        _equal(_port(try_opcost.run, x, idx, op=op, k=k), want)


# --------------------------------------------------------------- P1 reduce

@pytest.mark.parametrize("mode", try_reduce.MODES)
def test_reduce_matches_script(load_script, interpret, mode):
    ref = load_script("try_reduce")
    rng = _rng(1, try_reduce.MODES.index(mode))
    for x in (_tiles(rng, 3, 0, 100), _tiles(rng, 2, *WIDE)):
        for k in (1, 3):
            want = ref.run(jnp.asarray(x), mode=mode, k=k)
            _equal(_port(try_reduce.run, x, mode=mode, k=k), want)


# --------------------------------------------------------------- P2 loopcost

@pytest.mark.parametrize("dyn", [False, True])
def test_loopcost_matches_script(load_script, interpret, dyn):
    ref = load_script("try_loopcost")
    rng = _rng(2, int(dyn))
    for x in (np.zeros((2, SUB, LANE), np.int32), _tiles(rng, 3, *WIDE)):
        for n in (1, 5):
            want = ref.run(jnp.asarray(x), n_loops=n, dyn=dyn)
            _equal(_port(try_loopcost.run, x, n_loops=n, dyn=dyn), want)


# --------------------------------------------------------------- P3 loopcost2

@pytest.mark.parametrize("mode,carries", [
    ("noloop", 8), ("flat", 1), ("flat", 4), ("flat", 8), ("flat", 16),
    ("nested", 8), ("div", 8), ("div", 2)])
def test_loopcost2_matches_script(load_script, interpret, mode, carries):
    ref = load_script("try_loopcost2")
    rng = _rng(3, carries)
    for x in (np.zeros((2, SUB, LANE), np.int32), _tiles(rng, 3, 0, 1000)):
        for n in (1, 3):
            want = ref.run(jnp.asarray(x), mode=mode, n_loops=n,
                           n_carries=carries)
            _equal(_port(try_loopcost2.run, x, mode=mode, n_loops=n,
                         n_carries=carries), want)


def test_loopcost2_refuses_other_carries():
    x = torch.zeros((1, SUB, LANE), dtype=torch.int32)
    with pytest.raises(ValueError):
        try_loopcost2.run(x, mode="flat", n_loops=1, n_carries=3)


# --------------------------------------------------------------- P10 batchmin

@pytest.mark.parametrize("mode", try_batchmin.MODES)
def test_batchmin_matches_script(load_script, interpret, mode):
    ref = load_script("try_batchmin")
    x = _tiles(_rng(10), try_batchmin.NT, *WIDE)   # the script's grid: 64
    for reps in (1, 3):
        want = ref.run(jnp.asarray(x), mode=mode, reps=reps)
        _equal(_port(try_batchmin.run, x, mode=mode, reps=reps), want)


# --------------------------------------------------------------- P4 axis0

@pytest.mark.parametrize("mode", try_axis0.MODES)
def test_axis0_matches_script(load_script, interpret, mode):
    ref = load_script("try_axis0")
    rng = _rng(4)
    x = _tiles(rng, try_axis0.NT, *WIDE)              # the script's grid: 64
    idx = _tiles(rng, try_axis0.NT, -20, 20)          # the script takes % 8
    for reps in (1, 3):
        want = ref.run(jnp.asarray(x), jnp.asarray(idx), mode=mode, reps=reps)
        _equal(_port(try_axis0.run, x, idx, mode=mode, reps=reps), want)


# --------------------------------------------------------------- P6-P8 vgather

class _FirstCall(Exception):
    pass


@pytest.mark.parametrize("kernel", try_vgather.MODES)
def test_vgather_run_matches_script(load_script, monkeypatch, kernel):
    """The script's run times its kernel and returns ns: its first
    pallas_call's output is recorded (eagerly, under disable_jit), then the
    timing loop is stopped."""
    ref = load_script("try_vgather")
    outs = []
    orig = jpl.pallas_call

    def recording(*args, **kw):
        call = orig(*args, interpret=True, **kw)

        def first(*operands):
            outs.append(np.asarray(call(*operands)))
            raise _FirstCall

        return first

    monkeypatch.setattr(jpl, "pallas_call", recording)
    rng = _rng(6, try_vgather.MODES.index(kernel))
    x = rng.integers(0, 1000, (SUB, LANE)).astype(np.int32)
    idx = rng.integers(0, SUB, (SUB, LANE)).astype(np.int32)
    for reps in (1, 9):
        with jax.disable_jit(), pytest.raises(_FirstCall):
            ref.run(kernel, jnp.asarray(x), jnp.asarray(idx), reps)
        _equal(_port(try_vgather.run, kernel, x, idx, reps), outs[-1])


def test_vgather_kernels_match_script(load_script, interpret):
    ref = load_script("try_vgather")
    rng = _rng(7)
    out = jax.ShapeDtypeStruct((SUB, LANE), jnp.int32)
    x = rng.integers(0, 1000, (SUB, LANE)).astype(np.int32)
    idx = rng.integers(0, SUB, (SUB, LANE)).astype(np.int32)
    want = jpl.pallas_call(ref.k_vgather, out_shape=out)(jnp.asarray(x),
                                                         jnp.asarray(idx))
    _equal(_port(try_vgather.k_vgather, x, idx), want)
    x16 = rng.integers(0, 1000, (2 * SUB, LANE)).astype(np.int32)
    idx16 = rng.integers(-4, 2 * SUB, (SUB, LANE)).astype(np.int32)
    want = jpl.pallas_call(ref.k_vgather16, out_shape=out)(jnp.asarray(x16),
                                                           jnp.asarray(idx16))
    _equal(_port(try_vgather.k_vgather16, x16, idx16), want)
    inside = idx16 >= 0
    np.testing.assert_array_equal(
        _port(try_vgather.k_vgather16, x16, idx16)[inside],
        np.take_along_axis(x16, np.where(inside, idx16, 0), axis=0)[inside])


# --------------------------------------------------------------- P12 roll24

@pytest.mark.parametrize("d", repro_roll24.DS)
def test_roll24_matches_script(load_script, interpret, d):
    ref = load_script("repro_roll24")
    x = _rng(12).integers(-1000, 1000, (24, LANE)).astype(np.int32)
    for off in list(range(SUB)) + [-3, 29, -50]:
        o = np.full((1, 1), off, np.int32)
        want = ref.run(jnp.asarray(x), jnp.asarray(o), d=d)
        _equal(_port(repro_roll24.run, x, o, d=d), want)
        _equal(_port(repro_roll24.run, x, o, d=d),
               x[(np.arange(SUB) + off + d) % 24])


# --------------------------------------------------------------- P5 dyngrid

def test_dyngrid_matches_script(load_script, interpret):
    ref = load_script("try_dyngrid")
    t = 12
    x = _tiles(_rng(5), t, -1000, 1000)
    tl = np.zeros((t,), np.int32)
    tl[:5] = (9, 2, 5, 11, 0)
    for n in (1, 4, 5):
        want = ref.run(jnp.asarray(x), jnp.asarray(tl), jnp.int32(n),
                       max_tiles=t)
        x_t = torch.as_tensor(x)
        got = try_dyngrid.run(x_t, torch.as_tensor(tl),
                              torch.tensor(n, dtype=torch.int32), max_tiles=t)
        _equal(got.numpy(), want)
        _equal(x_t.numpy(), x)        # the input is left as it was


# --------------------------------------------------------------- P9 prim_bench

def _prim_inputs(rng, nt=3):
    return (_tiles(rng, nt, 0, 100), _tiles(rng, nt, 0, LANE),
            rng.integers(0, 60000, (4, 80, LANE)).astype(np.int32))


@pytest.mark.parametrize("op", ["shuf_dep", "shuf_indep", "roll_indep",
                                "scratch_rt", "onehot"])
def test_prim_matches_script(load_script, interpret, op):
    ref = load_script("prim_bench")
    x, idx, plane = _prim_inputs(_rng(9, prim_bench.OPS.index(op)))
    for k in (1, 3):
        want = ref.run(jnp.asarray(x), jnp.asarray(idx), jnp.asarray(plane),
                       op=op, k=k)
        _equal(_port(prim_bench.run, x, idx, plane, op=op, k=k), want)


def serve_trip_numpy(x, idx, plane, s_cells, k):
    """prim_bench.py:68-127 in numpy, one tile at a time; line 103 read as
    the dynamic slice of rows [q_al, q_al + 24) of the tile's plane block."""
    big = np.int32(1 << 29)
    out = np.empty_like(x)
    for t in range(x.shape[0]):
        acc, ix, pln = x[t], idx[t], plane[t % 4]
        rems = [(acc + 131 * p) % 997 for p in range(8)]
        accs = [np.zeros_like(acc) for _ in range(8)]
        ms = [r.min() for r in rems]
        for _ in range(k):
            new_rems = []
            for p in range(8):
                m = ms[p]
                q = int(np.clip(m // 4, 0, 64 - 24))
                q_al = (q // SUB) * SUB
                blk = pln[q_al:q_al + 3 * SUB]
                rolled = np.roll(blk, -(q - q_al), 0)
                rem = rems[p]
                for d in range(s_cells):
                    win = (rolled[0:SUB] if d == 0
                           else np.roll(rolled, 3 * SUB - d, 0)[0:SUB])
                    v = np.take_along_axis(win, ix, axis=1)
                    hit = (rem == m + d) & (m < big)
                    accs[p] = np.where(hit, v, accs[p])
                    rem = np.where(hit, big, rem)
                new_rems.append(rem + 1)
            rems = new_rems
            ms = [r.min() for r in rems]
        for a in accs:
            acc = acc + a
        out[t] = acc
    return out


@pytest.mark.parametrize("op", prim_bench.SERVE)
def test_serve_trip_matches_transcription(load_script, interpret, op):
    s_cells = int(op.rsplit("_", 1)[1])
    x, idx, plane = _prim_inputs(_rng(8, s_cells))
    ref = load_script("prim_bench")
    with pytest.raises(IndexError):      # prim_bench.py:103, while tracing
        ref.run(jnp.asarray(x), jnp.asarray(idx), jnp.asarray(plane),
                op=op, k=1)
    hits = 0
    for k in (0, 1, 3):
        want = serve_trip_numpy(x, idx, plane, s_cells, k)
        _equal(_port(prim_bench.run, x, idx, plane, op=op, k=k), want)
        hits += int((want != x).sum())
    assert hits > 0


@pytest.mark.parametrize("op", prim_bench.REFUSED)
def test_prim_mm_raises_like_script(load_script, interpret, op):
    ref = load_script("prim_bench")
    x, idx, plane = _prim_inputs(_rng(13))
    with pytest.raises(ValueError, match="dimension_numbers"):
        ref.run(jnp.asarray(x), jnp.asarray(idx), jnp.asarray(plane), op=op,
                k=2)
    for fn in (prim_bench.run, prim_bench.run_plain):
        with pytest.raises(ValueError, match=r"prim_bench\.py:132"):
            _port(fn, x, idx, plane, op=op, k=2)


# --------------------------------------------------------------- the tables

def test_probe_tables_need_a_card():
    """Each module's cases run on the CPU through the plain versions, and
    every main() refuses to measure without a card."""
    from beats3d_tpu_torch.probes import PROBES, tiles

    for probe in PROBES:
        args = probe.inputs("cpu")
        for case in probe.CASES:
            if case.refused:
                with pytest.raises(ValueError):
                    probe.call(args, case, case.ks[0])
                continue
            out = probe.call(args, case, case.ks[0])
            assert out.dtype == torch.int32
        if not torch.cuda.is_available():
            with pytest.raises(SystemExit):
                probe.main()
    assert tiles.ns_per_unit(tiles.Case("m", (), (8, 264), 64),
                             [1.0, 3.56]) == pytest.approx(2.56 / 256 / 64 * 1e6)
