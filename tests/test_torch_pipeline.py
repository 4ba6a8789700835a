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
from beats3d_tpu_torch.ops import components, hand_images_cuda
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
    got = hand_images_cuda.incoherent_images(
        torch.as_tensor(blob), 2, cfg_t.guard_spread,
        cfg_t.guard_tile_frac).numpy()
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


def _grown(rng, hs, ws, boxes):
    g = np.zeros((hs, ws), np.int32)
    for gid, (y0, y1, x0, x1) in boxes:
        g[y0:y1, x0:x1] = gid
    return g


@pytest.mark.parametrize("h,w,ch,cw", [(120, 212, 48, 64), (480, 848, 448, 512)])
def test_crop_origins_match_jax(rng, h, w, ch, cw):
    """The device-side origins and too_big against JAX's _crop_origins: no
    hand, one hand, hands at the image edges, random boxes and boxes too
    big for the window."""
    kw = dict(height=h, width=w, labels_reduce=2, crop_h=ch, crop_w=cw)
    cfg_t, cfg_j = tpipe.PipelineConfig(**kw), jpipe.PipelineConfig(**kw)
    hs, ws = -(-h // 8), -(-w // 8)
    cases = [[], [(1, (2, 5, 3, 6))], [(2, (0, 3, ws - 4, ws))],
             [(1, (hs - 2, hs, 0, 2)), (2, (0, hs, ws - 1, ws))],
             [(1, (0, hs, 0, ws // 2))]]
    for _ in range(8):
        boxes = []
        for gid in (1, 2):
            y0, x0 = rng.integers(0, hs - 1), rng.integers(0, ws - 1)
            boxes.append((gid, (y0, rng.integers(y0 + 1, hs + 1),
                                x0, rng.integers(x0 + 1, ws + 1))))
        cases.append(boxes)
    grown = np.stack([_grown(rng, hs, ws, b) for b in cases])
    oys, oxs, too_big = tpipe._crop_origins(torch.as_tensor(grown), cfg_t, h, w)
    assert oys.dtype == oxs.dtype == torch.int32 and too_big.dtype == torch.bool
    for i, g in enumerate(grown):
        want = jpipe._crop_origins(jnp.asarray(g), cfg_j, h, w)
        np.testing.assert_array_equal(oys[i].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(oxs[i].numpy(), np.asarray(want[1]))
        assert bool(too_big[i]) == bool(want[2]), i
    assert too_big.any() and not too_big.all()


@pytest.mark.parametrize("bad", [(), (1,), (0, 2), (0, 1, 3)])
def test_batch_nbad_matches_jax(pipes, bad):
    """B=4 with fallback_budget 2 and nbad = 0, 1, fb (the budgeted rescue
    on the device) and fb + 1 (the all-full-frame program)."""
    intrin, jp, tp = pipes
    frames = np.stack([_scene(intrin, t, big=t in bad) for t in range(4)])
    plane = _table_plane()
    got = tp.batch(frames, plane)
    want = jp.batch(jnp.asarray(frames), jnp.asarray(plane))
    _assert_outputs_match(got, want)


class _HostReads:
    """Tensor methods that read a value back to the host, patched to
    raise."""

    NAMES = ("item", "cpu", "tolist", "numpy", "__bool__", "__int__",
             "__index__")

    def __init__(self, monkeypatch):
        self.reads, self.lifted = [], False
        for name in self.NAMES:
            orig = getattr(torch.Tensor, name)
            monkeypatch.setattr(torch.Tensor, name, self._guard(name, orig))
        # the plain union-find's fixpoint test reads the host once per
        # round: the CPU's stand-in for the kernel's block-wide flag
        plain = components.label_components_plain

        def lifted(mask):
            self.lifted = True
            try:
                return plain(mask)
            finally:
                self.lifted = False

        monkeypatch.setattr(components, "label_components_plain", lifted)

    def _guard(self, name, orig):
        def read(t, *a, **kw):
            if not self.lifted:
                self.reads.append(name)
                raise AssertionError(f"host read: Tensor.{name}")
            return orig(t, *a, **kw)
        return read


@pytest.mark.parametrize("big", [False, True])
def test_frame_programs_read_nothing_back(pipes, monkeypatch, big):
    """frame_step and frame_step_batched read no tensor back to the host:
    their crop-or-full choices (and the batched rescue) are conds on the
    device."""
    intrin, _, tp = pipes
    depth = tp.as_depth(_scene(intrin, 1, big=big))
    batch = tp.as_depth(np.stack([_scene(intrin, t, big=big and t < 3)
                                  for t in range(4)]))
    plane = tp._plane(_table_plane())
    want = tpipe.frame_step(tp, depth, plane)
    want_b = tpipe.frame_step_batched(tp, batch, plane)
    reads = _HostReads(monkeypatch)
    got = tpipe.frame_step(tp, depth, plane)
    assert reads.reads == []
    got_b = tpipe.frame_step_batched(tp, batch, plane)
    assert reads.reads == []
    monkeypatch.undo()
    for a, b in ((got, want), (got_b, want_b)):
        for k in a:
            assert torch.equal(a[k].nan_to_num(), b[k].nan_to_num()), k


def test_frame_programs_run_mean_shift_through_its_kernel_wrapper(
        pipes, monkeypatch):
    """frame_step and frame_step_batched reach mean shift only through
    meanshift_cuda.mean_shift_cuda, which FrameGraph counts
    (pipeline.FRAME_KERNELS): every plain call comes from the wrapper, once
    per cond branch that runs it (eagerly every branch runs: crop and full;
    crop, rescue and full)."""
    from beats3d_tpu_torch.ops import meanshift, meanshift_cuda

    intrin, _, tp = pipes
    assert meanshift_cuda.mean_shift_cuda in tpipe.FRAME_KERNELS
    calls = {"wrapper": 0, "plain": 0}

    def counted(key, fn):
        def call(*args, **kw):
            calls[key] += 1
            return fn(*args, **kw)
        return call

    monkeypatch.setattr(meanshift_cuda, "mean_shift_cuda",
                        counted("wrapper", meanshift_cuda.mean_shift_cuda))
    monkeypatch.setattr(meanshift, "mean_shift",
                        counted("plain", meanshift.mean_shift))
    plane = tp._plane(_table_plane())
    tpipe.frame_step(tp, tp.as_depth(_scene(intrin, 1)), plane)
    assert calls == {"wrapper": 2, "plain": 2}
    batch = tp.as_depth(np.stack([_scene(intrin, t, big=t == 1)
                                  for t in range(3)]))
    tpipe.frame_step_batched(tp, batch, plane)
    assert calls == {"wrapper": 5, "plain": 5}


def test_frame_programs_move_hand_images_through_their_kernel_wrappers(
        pipes, monkeypatch):
    """frame_step and frame_step_batched make K1's hand images and place
    its labels only through hand_images_cuda.hand_images and place_labels,
    which FrameGraph counts (pipeline.FRAME_KERNELS): once each per cond
    branch that runs K1 (eagerly every branch runs: crop and full; crop,
    rescue and full), each plain call from its wrapper."""
    intrin, _, tp = pipes
    assert hand_images_cuda.hand_images in tpipe.FRAME_KERNELS
    assert hand_images_cuda.place_labels in tpipe.FRAME_KERNELS
    calls = dict.fromkeys(("images", "images_plain", "labels",
                           "labels_plain"), 0)

    def counted(key, fn):
        def call(*args, **kw):
            calls[key] += 1
            return fn(*args, **kw)
        return call

    for key, name in (("images", "hand_images"), ("labels", "place_labels")):
        monkeypatch.setattr(hand_images_cuda, name,
                            counted(key, getattr(hand_images_cuda, name)))
        monkeypatch.setattr(hand_images_cuda, f"{name}_plain",
                            counted(f"{key}_plain", getattr(
                                hand_images_cuda, f"{name}_plain")))
    plane = tp._plane(_table_plane())
    tpipe.frame_step(tp, tp.as_depth(_scene(intrin, 1)), plane)
    assert set(calls.values()) == {2}
    batch = tp.as_depth(np.stack([_scene(intrin, t, big=t == 1)
                                  for t in range(3)]))
    tpipe.frame_step_batched(tp, batch, plane)
    assert set(calls.values()) == {5}


def test_app_pipelined_matches_unpipelined(tmp_path, rng):
    """BeatsApp sends the same MIDI events pipelined (frame N's program
    queued before frame N-1's tap update) and not."""
    cfg_path = fixtures.layered_cfg_fixture(str(tmp_path), rng)
    intrin = CameraIntrinsics.d415(W, H)
    events = []
    for pipelined in (True, False):
        app = tapp.BeatsApp(
            LayeredDecisionForest.load(cfg_path, labels_reduce=2,
                                       device="cpu"),
            SyntheticSource(intrin), midi=Midi(),
            cfg=tapp.AppConfig(plane_num_iterations=64, group_min_size=0.02,
                               warmup_frames=2, min_velocity=5.0,
                               default_fingertip_thresholds=(120.0,) * 5,
                               pipelined=pipelined),
            log=lambda *a: None)
        app.calibrated_plane.plane = torch.as_tensor(_table_plane())
        assert app.run(max_frames=20) == 20
        events.append([msg for _, msg in app.midi.sink.events])
    assert len(events[0]) > 0, "the scene produced no MIDI events"
    assert events[0] == events[1]
