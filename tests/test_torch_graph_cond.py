"""The frame programs' conds and the incoherence guard's choice on the CPU.

(a) graph_cond.cond in its eager form (both branches run, torch.where
    selects) equals the taken branch's outputs bit for bit, over bool,
    int32, uint16 and float32 with NaN, for either predicate, nested, and
    refuses what lax.cond refuses.  Its capture form (conditional nodes of a
    CUDA graph) runs on the card: tests/test_torch_cuda.py.
(b) Where the port's kernel backend guards (pipeline.guards) against where
    JAX's TPU path does (its FramePipeline with backend="pallas": a model of
    at most 128 condition rows, guard_mode "skip", guard_spread > 0), for
    models of 128 and 129 rows; the guarded eval mutes exactly the flagged
    images.  The batched program against JAX's at nbad = 0, 1, fb and fb + 1
    is tests/test_torch_pipeline.py:test_batch_nbad_matches_jax."""

import os
import json
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fixtures

from beats3d_tpu.models import LayeredDecisionForest as JaxLayered
from beats3d_tpu.runtime import pipeline as jpipe
from beats3d_tpu.utils import CameraIntrinsics
from beats3d_tpu_torch import kernel_bench
from beats3d_tpu_torch.models import LayeredDecisionForest
from beats3d_tpu_torch.runtime import pipeline as tpipe
from beats3d_tpu_torch.runtime.graph_cond import cond


def _branches(dtype, rng):
    """Two (2, 5, 7) tensors of ``dtype`` from ``rng``; float ones hold
    NaN (of two payloads), -0.0 and infinities."""
    if dtype == torch.bool:
        a, b = (rng.random((2, 2, 5, 7)) < 0.5)
    elif dtype == torch.float32:
        a, b = rng.standard_normal((2, 2, 5, 7)).astype(np.float32)
        a[0, 0, :3] = np.nan
        b[0, 1, 2:] = np.frombuffer(np.uint32(0x7fc00001).tobytes(),
                                    np.float32)[0]
        a[1, 2, 0], b[1, 2, 1], a[1, 3, 3] = -0.0, np.inf, -np.inf
    else:
        info = np.iinfo({torch.int32: np.int32, torch.uint16: np.uint16}[dtype])
        a, b = rng.integers(info.min, info.max, (2, 2, 5, 7), endpoint=True,
                            dtype=np.int64)
    return (torch.as_tensor(np.asarray(a)).to(dtype),
            torch.as_tensor(np.asarray(b)).to(dtype))


def _bits(t):
    """A tensor's bits, for a bit-for-bit comparison (NaN payloads, -0.0)."""
    if t.dtype == torch.float32:
        return t.view(torch.int32)
    return t.to(torch.int32)


@pytest.mark.parametrize("dtype", [torch.bool, torch.int32, torch.uint16,
                                   torch.float32])
@pytest.mark.parametrize("p", [True, False])
def test_eager_cond_selects_the_taken_branch(dtype, p):
    rng = np.random.default_rng(5)
    a, b = _branches(dtype, rng)
    operand = torch.arange(3)

    def yes(x):
        return a.clone(), x * 2

    def no(x):
        return b.clone(), x + 5

    got = cond(torch.tensor(p), yes, no, operand)
    want = yes(operand) if p else no(operand)
    assert isinstance(got, tuple) and len(got) == 2
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(_bits(g), _bits(w))


@pytest.mark.parametrize("p,q", [(True, True), (True, False), (False, True),
                                 (False, False)])
def test_eager_cond_nested_and_single_tensor(p, q):
    x = torch.arange(6, dtype=torch.float32)

    def outer_yes(v):
        return cond(torch.tensor(q), lambda u: u * 10, lambda u: u - 1, v)

    got = cond(torch.tensor(p), outer_yes, lambda v: v + 100, x)
    want = (x * 10 if q else x - 1) if p else x + 100
    assert isinstance(got, torch.Tensor) and torch.equal(got, want)


@pytest.mark.parametrize("case", ["int_pred", "vector_pred", "shapes",
                                  "dtypes", "lengths", "not_tensors"])
def test_eager_cond_refuses(case):
    x = torch.zeros(3)
    pred, yes, no = torch.tensor(True), (lambda v: v), (lambda v: v + 1)
    if case == "int_pred":
        pred = torch.tensor(1)
    elif case == "vector_pred":
        pred = torch.tensor([True])
    elif case == "shapes":
        no = lambda v: torch.zeros(4)  # noqa: E731
    elif case == "dtypes":
        no = lambda v: v.to(torch.int32)  # noqa: E731
    elif case == "lengths":
        yes, no = (lambda v: (v, v)), (lambda v: (v,))
    else:
        yes = no = lambda v: 3  # noqa: E731
    with pytest.raises((ValueError, TypeError)):
        cond(pred, yes, no, x)


def _write_model(tmp_path, specs, cond_rows, colors):
    layers = []
    for i, (flat, fm, fc) in enumerate(specs):
        np.save(os.path.join(tmp_path, f"m{i}.npy"), flat)
        layer = {"model": f"m{i}.npy"}
        if fm is not None:
            layer.update(filter_model=fm, filter_model_class=fc)
        layers.append(layer)
    path = os.path.join(tmp_path, "model_cfg.json")
    with open(path, "w") as f:
        json.dump({"layers": layers, "conditions": cond_rows.tolist(),
                   "label_colors": colors.tolist()}, f)
    return path


@pytest.mark.parametrize("rows", [128, 129])
@pytest.mark.parametrize("mode,spread", [("skip", 1500), ("xla", 1500),
                                         ("skip", 0)])
def test_guard_choice_matches_jax(tmp_path, rows, mode, spread):
    """The port guards on the card where JAX's TPU path guards: its
    FramePipeline takes the Pallas kernel (which guards in mode "skip")
    only for a model of at most 128 condition rows.  On the CPU neither
    package guards."""
    specs, cond_rows, colors = kernel_bench.wide_layered(
        np.random.default_rng(rows), 2, 2, 3, rows, 3)
    path = _write_model(str(tmp_path), specs, cond_rows, colors)
    intrin = CameraIntrinsics.d415(212, 120)
    kw = dict(height=120, width=212, guard_mode=mode, guard_spread=spread)
    jp = jpipe.FramePipeline(JaxLayered.load(path, labels_reduce=2), intrin,
                             cfg=jpipe.PipelineConfig(**kw), backend="pallas")
    jax_guards = (jp.backend == "pallas" and jp.cfg.guard_spread > 0
                  and jp.cfg.guard_mode == "skip")
    tm = LayeredDecisionForest.load(path, labels_reduce=2, device="cpu")
    cfg = tpipe.PipelineConfig(**kw)
    assert tpipe.guards(cfg, tm) == jax_guards
    assert jax_guards == (rows == 128 and mode == "skip" and spread > 0)
    assert tpipe.PipelineConfig().guard_mode == jpipe.PipelineConfig().guard_mode
    on_cpu = jpipe.FramePipeline(JaxLayered.load(path, labels_reduce=2),
                                 intrin, cfg=jpipe.PipelineConfig(**kw))
    assert on_cpu.backend == "xla"                # unguarded off a TPU
    assert not tpipe.FramePipeline(tm, intrin, cfg=cfg).guarded


@pytest.mark.parametrize("guarded", [True, False])
def test_guarded_eval_mutes_the_flagged_images(tmp_path, rng, guarded):
    """The eval stage on a guarded pipeline zeroes the hand images the
    per-image guard flags (labels 65535, flags set) and leaves the others as
    the unguarded eval labels them; unguarded (guard_mode "xla", or a model
    past 128 rows) it is the plain eval with no flags.  The labels of each
    image are JAX's on the same (zeroed or not) image.  Each frame's right
    hand is the whole frame (group 1 everywhere), its left hand empty."""
    cfg_path = fixtures.layered_cfg_fixture(str(tmp_path), rng)
    tm = LayeredDecisionForest.load(cfg_path, labels_reduce=2, device="cpu")
    jm = JaxLayered.load(cfg_path, labels_reduce=2)
    # train_dim_x = width: probe offsets at scale 1, as JAX's run takes
    cfg = tpipe.PipelineConfig(height=96, width=512, train_dim_x=512)
    d = np.full((3, 96, 512), 65535, np.int32)
    yy, xx = np.mgrid[0:96, 0:512]
    blob = (yy - 48) ** 2 + (xx - 256) ** 2 < 40 ** 2
    d[0][blob] = 2300 + yy[blob]
    d[1] = rng.integers(1, 60000, (96, 512))
    d[2][blob] = 2300 + xx[blob]
    f = 1 << cfg.depth_mm_level
    grown = torch.ones((3, 96 // f, 512 // f), dtype=torch.int32)
    pipe = types.SimpleNamespace(model=tm, guarded=guarded, cfg=cfg)
    labels, flags = tpipe._hand_eval(pipe, torch.as_tensor(d), grown)
    want_flags = np.zeros(6, bool)
    want_flags[2] = guarded
    np.testing.assert_array_equal(flags.numpy(), want_flags)
    imgs = np.full((6, 96, 512), 65535, np.int32)
    imgs[0::2] = d
    safe = np.where(want_flags[:, None, None], 0, imgs).astype(np.uint16)
    np.testing.assert_array_equal(labels.numpy(),
                                  np.asarray(jm.run(jnp.asarray(safe))))
    assert (labels[2] == 65535).all() == guarded
