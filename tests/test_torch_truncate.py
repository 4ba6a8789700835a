"""The port's depth-truncation refit (beats3d_tpu_torch.scripts.
truncate_fine) against the repository's scripts/truncate_fine.py on the
CPU.

On tests/test_truncate.py's toy forest (trained by the JAX trainer, and by
the port's from the same seeds: byte-equal trees), for dt = 6, 5, 4, 3:
walk_ids' four arrays equal, refit_counts equal as integers, pdf_check's
dict equal, truncate's array and empty count byte-equal; then the port's
copies of the three JAX tests.  At full model width: the committed D=16
fine layer cut at dt = 13 over the two 480x848 frames of golden_eval.npz
(their labels as classes, 65535 read as 0) gives JAX's counts, check and
truncated array, and the committed serving variant (m1_serving.npy.gz),
loaded by the port, labels those frames as JAX's XLA layered evaluator
does, bit for bit.  Without a card, the scripts' entry points refuse to
run unless asked for the CPU."""

import gzip
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beats3d_tpu.data.dataset import ArrayDataset as JaxArrayDataset
from beats3d_tpu.models import LayeredDecisionForest as JaxLayered
from beats3d_tpu.models.forest import PackedForest as JaxPacked
from beats3d_tpu.models.layered import run_layered as jax_run_layered
from beats3d_tpu.train import train_forest as jax_train_forest
from beats3d_tpu_torch.data.dataset import ArrayDataset
from beats3d_tpu_torch.models import load_serving_flagship
from beats3d_tpu_torch.models.forest import PackedForest
from beats3d_tpu_torch.ops.forest_eval import evaluate_forest
from beats3d_tpu_torch.scripts import (bz3d_session_v2, flagship_v2,
                                       truncate_fine as tf)
from beats3d_tpu_torch.train import train_forest

from scripts import truncate_fine as jtf

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP = os.path.join(ROOT, "models", "flagship")


def _toy():
    """tests/test_truncate.py's toy problem."""
    rng = np.random.default_rng(42)
    n, h, w, c = 6, 24, 32, 4
    depth = rng.integers(600, 2400, (n, h, w)).astype(np.uint16)
    labels = ((depth // 500) % (c - 1) + 1).astype(np.uint16)
    labels[depth > 2100] = 0
    return depth, labels, c


TRAIN_KW = dict(num_random_features=16, proposals_per_block=8,
                images_per_block=3, max_tree_depth=6, trees_in_forest=2,
                trees_to_try=2, log=lambda *a: None)


@pytest.fixture(scope="module")
def trained():
    depth, labels, c = _toy()
    ds = JaxArrayDataset(depth, labels, c, images_per_block=3)
    forest = jax_train_forest(ds, ds, rng=np.random.default_rng(5),
                              **TRAIN_KW)
    tds = ArrayDataset(depth, labels, c, images_per_block=3)
    port = train_forest(tds, tds, rng=np.random.default_rng(5),
                        device="cpu", **TRAIN_KW)
    return forest.data, port.data, depth, labels.astype(np.int64)


def test_port_trains_the_toy_forest_byte_equal(trained):
    flat, port, _, _ = trained
    assert port.dtype == flat.dtype and port.tobytes() == flat.tobytes()


@pytest.mark.parametrize("dt", [6, 5, 4, 3])
def test_refit_equals_jax(trained, dt):
    flat, _, depth, labels = trained
    want = jtf.walk_ids(jnp.asarray(depth.astype(np.int32)),
                        JaxPacked.from_flat(flat).tables()[:dt], dt)
    got = tf.walk_ids(torch.as_tensor(depth.astype(np.int32)),
                      PackedForest.from_flat(torch.as_tensor(flat)).tables(),
                      dt)
    for g, w in zip(got, want):
        assert g.dtype == (torch.int32 if w.dtype == jnp.int32 else
                           torch.bool)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    jc, jv = jtf.refit_counts(flat, dt, depth, labels, chunk=3)
    tc, tv = tf.refit_counts(flat, dt, depth, labels, chunk=3, device="cpu")
    assert tc.dtype == tv.dtype == np.int64
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_array_equal(tv, jv)
    assert tf.pdf_check(flat, dt, tv) == jtf.pdf_check(flat, dt, jv)
    (ta, te), (ja, je) = tf.truncate(flat, dt, tc), jtf.truncate(flat, dt, jc)
    assert te == je and ta.dtype == ja.dtype and ta.tobytes() == ja.tobytes()


def _acc(flat, depth, labels):
    tables = PackedForest.from_flat(torch.as_tensor(flat)).tables()
    out = evaluate_forest(torch.as_tensor(depth.astype(np.int32)),
                          tables).numpy()
    m = labels > 0
    return float((out[m] == labels[m]).mean())


def test_refit_reproduces_trainer_pdfs(trained):
    """The refit walk lands the training pixels in the trainer's leaves:
    its histograms reproduce their stored pdfs (tests/test_truncate.py's
    bounds)."""
    flat, _, depth, labels = trained
    mixed_any = checked_any = False
    for dt in (6, 5, 4, 3):
        _, vcounts = tf.refit_counts(flat, dt, depth, labels, chunk=3,
                                     device="cpu")
        chk = tf.pdf_check(flat, dt, vcounts)
        if chk["checked"]:
            checked_any = True
            assert chk["dev_cutoff"] <= 1e-3 + 1e-6, (dt, chk)
            assert chk["bad_leaves"] == 0, (dt, chk)
        if chk["mixed"]:
            mixed_any = True
            assert chk["dev_mixed"] < 1e-6, (dt, chk)
    assert checked_any and mixed_any


def test_truncate_full_depth_is_identity(trained):
    flat, _, depth, labels = trained
    counts, _ = tf.refit_counts(flat, 6, depth, labels, chunk=3,
                                device="cpu")
    assert counts.sum() == 0
    trunc, empty = tf.truncate(flat, 6, counts)
    np.testing.assert_array_equal(trunc, flat)
    assert empty == 0


def test_truncated_model_valid_and_close(trained):
    flat, _, depth, labels = trained
    base = _acc(flat, depth, labels)
    prev = 1.0
    for dt in (5, 4):
        counts, _ = tf.refit_counts(flat, dt, depth, labels, chunk=3,
                                    device="cpu")
        trunc, _ = tf.truncate(flat, dt, counts)
        assert trunc.shape[1] == (1 << dt) - 1
        last = trunc[:, (1 << (dt - 1)) - 1 :]
        assert (np.floor(last[:, :, 5:7]) != -1).all()
        acc = _acc(trunc, depth, labels)
        assert acc <= prev + 1e-9
        assert acc > base - 0.35
        prev = acc
    assert base > 0.6


@pytest.fixture(scope="module")
def golden():
    z = np.load(os.path.join(FLAGSHIP, "golden_eval.npz"))
    labels = z["labels"].astype(np.int64)
    labels[labels == 65535] = 0
    return z["depth"], labels


def test_committed_fine_layer_at_13_equals_jax(golden, monkeypatch):
    """The committed D=16 fine layer cut at 13 over the golden frames at
    full width: counts, check and truncated forest equal JAX's."""
    depth, labels = golden
    monkeypatch.setattr(flagship_v2, "OUT", FLAGSHIP)
    monkeypatch.setattr(jtf, "FLAGSHIP", FLAGSHIP)
    flat = tf.load_fine_flat()
    np.testing.assert_array_equal(flat, jtf.load_fine_flat())
    assert flat.shape == (4, 65535, 21)
    jc, jv = jtf.refit_counts(flat, 13, depth, labels)
    tc, tv = tf.refit_counts(flat, 13, depth, labels, device="cpu")
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_array_equal(tv, jv)
    assert tc.sum() > 0 and tv.sum() > 0
    assert tf.pdf_check(flat, 13, tv) == jtf.pdf_check(flat, 13, jv)
    (ta, te), (ja, je) = tf.truncate(flat, 13, tc), jtf.truncate(flat, 13, jc)
    assert te == je and ta.tobytes() == ja.tobytes()
    assert ta.shape == (4, 8191, 21)


def test_serving_variant_labels_equal_jax(golden, tmp_path):
    """m1_serving.npy.gz through the port's serving loader labels the
    golden frames as JAX's XLA evaluator does on the model bench.py
    stages (full resolution, as the held-out accuracy reads them)."""
    depth, _ = golden
    for name in ("m0.npy", "model_cfg.json"):
        shutil.copy(os.path.join(FLAGSHIP, name), tmp_path / name)
    with gzip.open(os.path.join(FLAGSHIP, "m1_serving.npy.gz"), "rb") as f:
        (tmp_path / "m1.npy").write_bytes(f.read())
    jm = JaxLayered.load(str(tmp_path / "model_cfg.json"), labels_reduce=2)
    fs = tuple((l.filter_model, l.filter_model_class) for l in jm.layers)
    want = np.asarray(jax_run_layered(
        jnp.asarray(depth), jm.layer_tables(), jm.conditions,
        filter_specs=fs, labels_reduce=1, scale_factor=jnp.float32(1.0),
        backend="xla"))
    model = load_serving_flagship("cpu")
    assert model.layers[1].forest.max_depth == 13
    assert model.filter_specs() == fs
    got = flagship_v2.eval_chunked(model, depth)
    assert got.dtype == want.dtype == np.uint16
    np.testing.assert_array_equal(got, want)
    assert (got != 65535).sum() > 10000


@pytest.mark.parametrize("entry", ["flagship_v2", "truncate_fine",
                                   "bz3d_session_v2"])
def test_entry_points_refuse_without_card(entry, monkeypatch, tmp_path):
    """Without a card and without B3D_TRUNC_CPU or device="cpu", each
    script's main raises before it writes anything."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    monkeypatch.delenv("B3D_TRUNC_CPU", raising=False)
    mod = {"flagship_v2": flagship_v2, "truncate_fine": tf,
           "bz3d_session_v2": bz3d_session_v2}[entry]
    for name in ("OUT", "DS"):          # every script's output directories
        monkeypatch.setattr(flagship_v2, name, str(tmp_path / name))
    with pytest.raises(RuntimeError, match="no CUDA card"):
        mod.main([])
    assert not os.listdir(tmp_path)
