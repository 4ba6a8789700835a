"""The port's flagship build and session (beats3d_tpu_torch.scripts.
flagship_v2 and bz3d_session_v2) against the repository's
scripts/flagship_v2.py and scripts/bz3d_session_v2.py on the CPU, at a
small size: 424x240 frames, 8 training and 4 held-out frames, a coarse
layer of depth 3 and a fine layer of depth 5, 2 trees, 16 proposals in
blocks of 8; the session calibrates from 1,024 RANSAC candidates.

The JAX script makes the dataset and its model (its layered kernel's call
answered by its plain reference, the XLA evaluator); the port's build then
trains on the same dataset
(``B3D_V2_REUSE=1``).  m0.npy, m1 (un-gzipped), model_cfg.json and the
arrays of golden_eval.npz must be byte-equal (the zip's own headers carry
the time of writing), the trainers' pct_match values equal, and the
held-out accuracy equal.  Then a short session of the recipe's bouncing
hands through both BeatsApps with that model, calibrating from the same
RANSAC uniforms: the same MIDI note events, labels bit-exact, mean-shift
modes to 1e-3 px, heights to rtol 1e-5 (within 10 units of the table,
to 1e-5 of the table's depth).  The 5x5 gaussian is the one step that
may differ by design (ROADMAP C-w4: +-1 against XLA's convolution on exact ties, which moves a
label now and then): the port's is held to JAX's within 1 on every frame,
and JAX's is used in its place."""

import dataclasses
import functools
import gzip
import json
import os
import shutil
import sys
import zipfile

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from beats3d_tpu.models import LayeredDecisionForest as JaxLayered
from beats3d_tpu.ops import points as jpoints
from beats3d_tpu.utils import CameraIntrinsics as JaxIntrinsics
from beats3d_tpu_torch.data.dataset import DatasetConfig
from beats3d_tpu_torch.models import load_flagship
from beats3d_tpu_torch.scripts import bz3d_session_v2, flagship_v2
from beats3d_tpu_torch.scripts import truncate_fine as tf
from beats3d_tpu_torch.ops import points as tpoints
from beats3d_tpu_torch.utils import CameraIntrinsics

from test_torch_datagen import JaxStreamPlane

import beats3d_tpu.models.layered as jlayered
import beats3d_tpu.runtime.app as japp
import beats3d_tpu.train
from scripts import bz3d_session_v2 as jsession
from scripts import flagship_v2 as jflagship
from scripts import truncate_fine as jtf

W, H = 424, 240
N_TRAIN, N_TEST = 8, 4
SESSION_FRAMES = 14
TABLE_Z = 2600.0         # the synthetic table's depth (data.synth.table_depth)
NEAR_TABLE = 10.0        # heights held to the table's scale below this
SMALL = dict(FINE_DEPTH=5, COARSE_DEPTH=3, TREES=2, PROPOSALS=16,
             PROPOSALS_BLOCK=8, IMAGES_PER_BLOCK=4)
SESSION_CANDIDATES = 1024       # RANSAC planes (the recipe's 8192 at 848x480)


def _quiet(*a):
    pass


def _xla_reference(run_layered):
    """JAX's run_layered with its Pallas backend answered by the XLA
    evaluator, its plain reference (the tables given are the XLA ones:
    ``layer_tables_pallas`` is patched to return them)."""
    def run(depth, tables, conditions, *, backend="xla", metas=None,
            conditions_packed=None, num_cond=None, **kw):
        return run_layered(depth, tables, conditions, backend="xla", **kw)
    return run


def _recording(fn, seen):
    """``fn`` (a train_forest) that also records each forest's
    pct_match."""
    def wrapped(*args, **kw):
        forest = fn(*args, **kw)
        seen.append(forest.pct_match)
        return forest
    return wrapped



@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU work here is many small operations: on one thread
    each, they do not oversubscribe the cores the suite's other workers
    share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

@pytest.fixture(scope="module")
def builds(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("flagship")
    ds, jout, tout = tmp / "ds", tmp / "jax", tmp / "port"
    seen = {"jax": [], "port": []}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("BEATS3D_COMPILE_CACHE", str(tmp / "xla_cache"))
        mp.setattr(JaxIntrinsics, "d415",
                   staticmethod(functools.partial(JaxIntrinsics.d415, W, H)))
        mp.setattr(jlayered, "run_layered",
                   _xla_reference(jlayered.run_layered))
        mp.setattr(JaxLayered, "layer_tables_pallas",
                   JaxLayered.layer_tables)
        mp.setattr(beats3d_tpu.train, "train_forest", _recording(
            beats3d_tpu.train.train_forest, seen["jax"]))
        for mod, out in ((jflagship, jout), (flagship_v2, tout)):
            mp.setattr(mod, "OUT", str(out))
            mp.setattr(mod, "DS", str(ds))
            for name, value in SMALL.items():
                mp.setattr(mod, name, value)
        mp.setattr(sys, "argv", ["flagship_v2.py", str(N_TRAIN),
                                 str(N_TEST)])
        jflagship.main()
        mp.setenv("B3D_V2_REUSE", "1")
        mp.setattr(flagship_v2, "train_forest", _recording(
            flagship_v2.train_forest, seen["port"]))
        summary = flagship_v2.main(
            [str(N_TRAIN), str(N_TEST)], device="cpu",
            intrin=CameraIntrinsics.d415(W, H), log=_quiet)
    return dict(ds=ds, jax=jout, port=tout, seen=seen, summary=summary)


def _read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("name", ["m0.npy", "m1.npy.gz", "model_cfg.json"])
def test_model_files_byte_equal(builds, name):
    got, want = (_read(builds[k] / name) for k in ("port", "jax"))
    if name.endswith(".gz"):
        got, want = gzip.decompress(got), gzip.decompress(want)
    assert got == want
    assert not (builds["port"] / "m1.npy").exists()


def test_golden_eval_arrays_byte_equal(builds):
    zips = [zipfile.ZipFile(builds[k] / "golden_eval.npz")
            for k in ("port", "jax")]
    names = [sorted(z.namelist()) for z in zips]
    assert names[0] == names[1] == ["depth.npy", "labels.npy"]
    for name in names[0]:
        assert zips[0].read(name) == zips[1].read(name), name
    labels = np.load(builds["port"] / "golden_eval.npz")["labels"]
    assert labels.shape == (2, H, W) and (labels != 65535).any()


def test_pct_match_and_results_equal(builds):
    seen = builds["seen"]
    assert len(seen["port"]) == len(seen["jax"]) == 2   # coarse, fine
    assert seen["port"] == seen["jax"]
    got, want = builds["summary"], json.loads(
        _read(builds["jax"] / "RESULTS.json"))
    assert json.loads(_read(builds["port"] / "RESULTS.json")) == got
    assert got["k1_plain_mismatches"] == want["pallas_xla_mismatches"] == 0
    for key in ("layered_pct_match_unseen",):
        assert got[key] == want[key]
    for layer in ("coarse", "fine"):
        for key in ("depth", "trees", "pct_match"):
            assert got[layer][key] == want[layer][key], (layer, key)
    assert got["dataset"]["images"] == N_TRAIN + N_TEST
    assert got["streaming"]["raw_mb"] == want["streaming"]["raw_mb"]


def test_heldout_acc_equals_jax(builds, tmp_path):
    """truncate_fine's held-out accuracy (K1's plain version here) of the
    built model and of its fine layer cut at depth 4, against JAX's."""
    train, test = DatasetConfig.multiple(str(builds["ds"]), [
        (N_TRAIN, 4, "train"), (N_TEST, None, "test")], ordered=True)
    depth, labels = test.get_depth_block(0), test.get_labels_block(0)
    with gzip.open(builds["port"] / "m1.npy.gz") as f:
        flat = np.load(f)
    train_depth = np.concatenate([train.get_depth_block(i) for i in range(2)])
    train_labels = np.concatenate(
        [train.get_labels_block(i) for i in range(2)]).astype(np.int64)
    row, trunc = tf.sweep_depth(flat, 4, train_depth, train_labels, "cpu")
    tf.write_model_dir(str(tmp_path / "d4"), trunc, src=str(builds["port"]))
    # the JAX package loads m1.npy only
    (builds["port"] / "m1.npy").write_bytes(gzip.decompress(
        _read(builds["port"] / "m1.npy.gz")))
    try:
        for mdir in (builds["port"], tmp_path / "d4"):
            got = tf.heldout_acc(str(mdir), depth, labels, "cpu")
            want = jtf.heldout_acc(str(mdir), depth, labels)
            assert got == want and 0.0 < got <= 1.0
    finally:
        os.remove(builds["port"] / "m1.npy")
    assert row["refit_platform"] == "cpu"


def _gaussian_as_jax(monkeypatch):
    """The port's gaussian_depth_filter, held within 1 of the JAX
    package's on each image of each call (C-w4), returning JAX's; records
    per call the pixels where the two differ."""
    differ = []
    orig = tpoints.gaussian_depth_filter

    def gauss(depth, kernel):
        got = orig(depth, kernel)
        want = torch.stack([torch.as_tensor(np.asarray(
            jpoints.gaussian_depth_filter(
                jnp.asarray(d.numpy().astype(np.uint16)),
                jnp.asarray(kernel)))).to(got.dtype)
            for d in depth.reshape(-1, *depth.shape[-2:])]).reshape(got.shape)
        assert int((got.to(torch.int64) - want).abs().max()) <= 1
        differ.append(int((got != want).sum()))
        return want

    monkeypatch.setattr(tpoints, "gaussian_depth_filter", gauss)
    return differ


class _Recorded(japp.BeatsApp):
    """The JAX BeatsApp, keeping each tick's output and itself."""

    made = []

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.outs = []
        _Recorded.made.append(self)

    def tick(self, frame):
        out = super().tick(frame)
        self.outs.append(out)
        return out


def test_session_equals_jax(builds, tmp_path, monkeypatch):
    """The recipe's session (seed 5's bouncing hands) through the JAX and
    the port's BeatsApp with the built model and the same RANSAC
    uniforms."""
    model_dir = tmp_path / "model"
    shutil.copytree(builds["port"], model_dir)
    (model_dir / "m1.npy").write_bytes(gzip.decompress(
        _read(model_dir / "m1.npy.gz")))
    monkeypatch.setenv("BEATS3D_COMPILE_CACHE", str(tmp_path / "xla_cache"))
    monkeypatch.setattr(JaxIntrinsics, "d415", staticmethod(
        functools.partial(JaxIntrinsics.d415, W, H)))
    import bench

    monkeypatch.setattr(bench, "load_flagship", lambda: JaxLayered.load(
        str(model_dir / "model_cfg.json"), labels_reduce=2))
    monkeypatch.setattr(japp, "BeatsApp", _Recorded)
    app_config = japp.AppConfig
    monkeypatch.setattr(japp, "AppConfig", lambda **kw: app_config(
        **dict(kw, plane_num_iterations=SESSION_CANDIDATES)))
    small_cfg = dataclasses.replace(bz3d_session_v2.app_config(),
                                    plane_num_iterations=SESSION_CANDIDATES)
    monkeypatch.setattr(bz3d_session_v2, "app_config", lambda: small_cfg)
    monkeypatch.setattr(jsession, "OUT", str(model_dir))
    monkeypatch.setattr(sys, "argv", ["bz3d_session_v2.py",
                                      str(SESSION_FRAMES)])
    _Recorded.made.clear()
    jsession.main()
    (ja,) = _Recorded.made
    want_rec = json.loads(_read(model_dir / "RESULTS.json"))["bz3d_session"]

    intrin = CameraIntrinsics.d415(W, H)
    frames = bz3d_session_v2.session_frames(intrin, SESSION_FRAMES)
    model = load_flagship("cpu", str(model_dir))
    outs = []
    gauss_differ = _gaussian_as_jax(monkeypatch)
    rec, ta = bz3d_session_v2.run_session(
        model, intrin, frames,
        plane=JaxStreamPlane(SESSION_CANDIDATES,
                             small_cfg.plane_z_outlier_threshold),
        on_tick=lambda o: outs.append(o) or o)
    assert len(outs) == len(ja.outs) == SESSION_FRAMES
    assert len(gauss_differ) == SESSION_FRAMES - 2      # after the warm-up
    assert [e[1:] for e in ta.midi.sink.note_events()] == \
        [e[1:] for e in ja.midi.sink.note_events()]
    for key in ("frames", "note_ons", "note_events", "label_histogram"):
        assert rec[key] == want_rec[key], key
    assert rec["note_events"] > 0, "the session played no note"
    checked = 0
    for got, want in zip(outs + [ta.last_out], ja.outs + [ja.last_out]):
        assert (got is None) == (want is None)
        if got is None:
            continue
        np.testing.assert_array_equal(got["labels"].numpy(),
                                      np.asarray(want["labels"]))
        v = got["tip_valid"].numpy()
        np.testing.assert_array_equal(v, np.asarray(want["tip_valid"]))
        # heights to rtol 1e-5; a height is a difference of plane-space
        # terms of the table's depth (~2600 units), so a fingertip near the
        # table (|height| < NEAR_TABLE) is held to 1e-5 of that scale
        hg, hw = got["heights"].numpy()[v], np.asarray(want["heights"])[v]
        near = np.abs(hw) < NEAR_TABLE
        np.testing.assert_allclose(hg[~near], hw[~near], rtol=1e-5)
        np.testing.assert_allclose(hg[near], hw[near], rtol=0,
                                   atol=1e-5 * TABLE_Z)
        m_got, m_want = got["means"].numpy(), np.asarray(want["means"])
        np.testing.assert_array_equal(np.isnan(m_got), np.isnan(m_want))
        np.testing.assert_allclose(m_got, m_want, rtol=0, atol=1e-3)
        checked += 1
    assert checked >= SESSION_FRAMES - 3
    assert (ta.last_out["labels"].numpy() != 65535).any()
