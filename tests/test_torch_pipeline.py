"""The port's slice as a whole against the JAX package on the CPU.

(a) tests/goldens/session.npz with tests/goldens/model/: labels exact,
    heights and g_info rtol 1e-5 (as test_golden_session.py).
(b) FramePipeline against JAX's FramePipeline(backend="xla") on small
    two-hand scenes with a 48x64 crop window: single frames and .batch
    with B=3, one frame oversized so the full-frame rescue runs.  Labels,
    g_info and tip_valid exact; means atol 1e-3 px with the same NaN
    pattern; heights rtol 1e-5 (mean shift sums in another order).
(c) BeatsApp against the JAX BeatsApp over 20 SyntheticSource frames with
    the same plane: identical MIDI message tuples.
(d) The synthetic articulated hand frames the bench and chip_smoke.py
    drive: identical to the JAX package's."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fixtures

from beats3d_tpu.data import synth as jsynth
from beats3d_tpu.models import LayeredDecisionForest as JaxLayered
from beats3d_tpu.runtime import app as japp
from beats3d_tpu.runtime import pipeline as jpipe
from beats3d_tpu.runtime.camera import SyntheticSource as JaxSource
from beats3d_tpu.runtime.midi import Midi as JaxMidi
from beats3d_tpu.utils import CameraIntrinsics
from beats3d_tpu_torch.data import synth
from beats3d_tpu_torch.models import LayeredDecisionForest
from beats3d_tpu_torch.runtime import app as tapp
from beats3d_tpu_torch.runtime import pipeline as tpipe
from beats3d_tpu_torch.runtime.camera import SyntheticSource
from beats3d_tpu_torch.runtime.midi import Midi

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "goldens", "session.npz")
GOLDEN_MODEL = os.path.join(HERE, "goldens", "model", "model_cfg.json")
H, W = 120, 212


def test_golden_session():
    data = np.load(GOLDEN)
    model = LayeredDecisionForest.load(GOLDEN_MODEL, labels_reduce=2,
                                       device="cpu")
    pipe = tpipe.FramePipeline(
        model, CameraIntrinsics.d415(W, H),
        cfg=tpipe.PipelineConfig(height=H, width=W, labels_reduce=2),
        group_min_size=0.02)
    assert pipe.backend == "torch"
    for i in range(data["frames"].shape[0]):
        out = pipe(data["frames"][i], data["plane"])
        assert out["labels"].dtype == torch.uint16
        np.testing.assert_array_equal(out["labels"].numpy(), data["labels"][i])
        np.testing.assert_allclose(out["heights"].numpy(), data["heights"][i],
                                   rtol=1e-5)
        np.testing.assert_allclose(out["g_info"].numpy(), data["g_info"][i],
                                   rtol=1e-5)


def _table_plane():
    n = np.array([0.03, -0.06, 1.0])
    n /= np.linalg.norm(n)
    a = np.cross(n, [1, 0, 0.0])
    a /= np.linalg.norm(a)
    rot = np.stack([a, np.cross(n, a), n])
    mat = np.eye(4, dtype=np.float32)
    mat[:3, :3] = rot
    mat[:3, 3] = -rot @ np.array([0.0, 0.0, 2600.0 / n[2]])
    return mat


def _scene(intrin, t, radius=11, big=False):
    h, w = intrin.height, intrin.width
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    n = np.array([0.03, -0.06, 1.0])
    n /= np.linalg.norm(n)
    depth = (2600.0 - n[0] * (xx - intrin.ppx) * 8
             - n[1] * (yy - intrin.ppy) * 8) / n[2]
    for k, cx in enumerate((0.3 * w + 2 * t, 0.72 * w - 3 * t)):
        r = 40 if (big and k == 0) else radius
        blob = (xx - cx) ** 2 + (yy - h / 2 - t) ** 2 < r * r
        depth[blob] -= 300.0 + 7.0 * t
    return depth.astype(np.uint16)


@pytest.fixture
def pipes(tmp_path, rng):
    cfg_path = fixtures.layered_cfg_fixture(str(tmp_path), rng)
    intrin = CameraIntrinsics.d415(W, H)
    kw = dict(height=H, width=W, labels_reduce=2, crop_h=48, crop_w=64)
    jp = jpipe.FramePipeline(JaxLayered.load(cfg_path, labels_reduce=2),
                             intrin, cfg=jpipe.PipelineConfig(**kw),
                             group_min_size=0.01, backend="xla")
    tp = tpipe.FramePipeline(
        LayeredDecisionForest.load(cfg_path, labels_reduce=2, device="cpu"),
        intrin, cfg=tpipe.PipelineConfig(**kw), group_min_size=0.01)
    return intrin, jp, tp


def _assert_outputs_match(got, want):
    for k in ("labels", "g_info", "tip_valid", "tip_px", "guard_muted"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    m_got, m_want = got["means"].numpy(), np.asarray(want["means"])
    np.testing.assert_array_equal(np.isnan(m_got), np.isnan(m_want))
    np.testing.assert_allclose(m_got, m_want, rtol=0, atol=1e-3)
    v = got["tip_valid"].numpy()
    np.testing.assert_allclose(got["heights"].numpy()[v],
                               np.asarray(want["heights"])[v], rtol=1e-5)


@pytest.mark.parametrize("t,big", [(0, False), (2, False), (1, True)])
def test_frame_matches_jax(pipes, t, big):
    intrin, jp, tp = pipes
    depth, plane = _scene(intrin, t, big=big), _table_plane()
    got = tp(depth, plane)
    want = jp(jnp.asarray(depth), jnp.asarray(plane))
    assert np.asarray(want["g_info"])[:, 0].min() > 0, "a hand is missing"
    _assert_outputs_match(got, want)
    np.testing.assert_array_equal(got["groups_small"].numpy(),
                                  np.asarray(want["groups_small"]))


@pytest.mark.parametrize("budget", [2, 0])
def test_batch_with_rescue_matches_jax(tmp_path, rng, budget):
    """B=3 with frame 1 oversized: budget 2 keeps the crop path for frames
    0 and 2 and rescues frame 1 full-frame; budget 0 runs the whole batch
    full-frame."""
    cfg_path = fixtures.layered_cfg_fixture(str(tmp_path), rng)
    intrin = CameraIntrinsics.d415(W, H)
    kw = dict(height=H, width=W, labels_reduce=2, crop_h=48, crop_w=64,
              fallback_budget=budget)
    jp = jpipe.FramePipeline(JaxLayered.load(cfg_path, labels_reduce=2),
                             intrin, cfg=jpipe.PipelineConfig(**kw),
                             group_min_size=0.01, backend="xla")
    tp = tpipe.FramePipeline(
        LayeredDecisionForest.load(cfg_path, labels_reduce=2, device="cpu"),
        intrin, cfg=tpipe.PipelineConfig(**kw), group_min_size=0.01)
    frames = np.stack([_scene(intrin, 0), _scene(intrin, 1, big=True),
                       _scene(intrin, 2)])
    plane = _table_plane()
    got = tp.batch(frames, plane)
    want = jp.batch(jnp.asarray(frames), jnp.asarray(plane))
    _assert_outputs_match(got, want)
    single = tp(frames[1], plane)
    np.testing.assert_array_equal(got["labels"][1].numpy(),
                                  single["labels"].numpy())


@pytest.mark.parametrize("seed,kw", [
    (1000, dict(two_hands=True, flex_scale=0.3)),
    (7, dict(flex_scale=1.0, detail=2.0, noise_scale=1.0)),
])
def test_articulated_scene_matches_jax(seed, kw):
    """The port's numpy splat renderer makes the JAX package's synthetic
    hand frames pixel for pixel (the first is the bench's two-hand scene)."""
    intrin = CameraIntrinsics.d415()
    want_d, want_c = jsynth.articulated_scene(
        intrin, np.random.default_rng(seed), **kw)
    got_d, got_c = synth.articulated_scene(
        intrin, np.random.default_rng(seed), **kw)
    assert got_d.dtype == np.uint16 and got_c.dtype == np.uint8
    np.testing.assert_array_equal(got_d, want_d)
    np.testing.assert_array_equal(got_c, want_c)


def test_guard_flags_match_jax(rng):
    """The incoherence guard's per-image flags (the guard runs only on the
    kernel backend) against the JAX function."""
    cfg_t = tpipe.PipelineConfig()
    cfg_j = jpipe.PipelineConfig()
    blob = np.zeros((3, 96, 512), np.int32)
    blob[:, 30:60, 100:300] = 2500
    blob[1] = rng.integers(1, 60000, blob[1].shape)
    blob[2, 30:60, 100:300] = rng.integers(2000, 2600, (30, 200))
    blob[2, 30:60, 100:300:7] = 9000
    got = tpipe._incoherent_images(torch.as_tensor(blob), 2, cfg_t).numpy()
    want = np.asarray(jpipe._incoherent_images(jnp.asarray(blob), 2, cfg_j))
    np.testing.assert_array_equal(got, want)
    assert got[1] and not got[0]


def test_app_midi_matches_jax(tmp_path, rng):
    cfg_path = fixtures.layered_cfg_fixture(str(tmp_path), rng)
    intrin = CameraIntrinsics.d415(W, H)
    kw = dict(plane_num_iterations=64, group_min_size=0.02, warmup_frames=2,
              min_velocity=5.0,
              default_fingertip_thresholds=(120.0,) * 5)
    plane = _table_plane()
    ja = japp.BeatsApp(JaxLayered.load(cfg_path, labels_reduce=2),
                       JaxSource(intrin), midi=JaxMidi(),
                       cfg=japp.AppConfig(**kw), log=lambda *a: None)
    ja.calibrated_plane.plane = jnp.asarray(plane)
    ta = tapp.BeatsApp(
        LayeredDecisionForest.load(cfg_path, labels_reduce=2, device="cpu"),
        SyntheticSource(intrin), midi=Midi(), cfg=tapp.AppConfig(**kw),
        log=lambda *a: None)
    ta.calibrated_plane.plane = torch.as_tensor(plane)
    assert ja.run(max_frames=20) == ta.run(max_frames=20) == 20
    want = [msg for _, msg in ja.midi.sink.events]
    got = [msg for _, msg in ta.midi.sink.events]
    assert len(want) > 0, "the scene produced no MIDI events"
    assert got == want
    assert ta.labels_rgba().shape == (H // 2, W // 2, 4)
