"""The port's forest training (beats3d_tpu_torch.train) against the JAX
package's trainer on the CPU and the scalar oracle, on the same seeded
inputs: histograms, one tree with injected proposals, the whole
train_forest driver (resident, streamed, resumed), saved forests, and the
training and evaluation apps.  Trees and counts must be byte-equal and
pct_match equal."""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fixtures
import oracle

from beats3d_tpu.data.dataset import ArrayDataset as JaxArrayDataset
from beats3d_tpu.models.forest import DecisionForest as JaxForest
from beats3d_tpu.models.forest import DecisionTree as JaxTree
from beats3d_tpu.train import DecisionTreeTrainer as JaxTrainer
from beats3d_tpu.train import train_forest as jax_train_forest
from beats3d_tpu.train.trainer import _histogram_step, _histogram_step_from_bits
from beats3d_tpu_torch.data.blocks import CompressedDataset
from beats3d_tpu_torch.data.dataset import ArrayDataset, write_dataset
from beats3d_tpu_torch.models.forest import DecisionForest, DecisionTree
from beats3d_tpu_torch.ops.train_features import train_feature_bits_plain
from beats3d_tpu_torch.train import DecisionTreeTrainer, make_random_features
from beats3d_tpu_torch.train import driver, trainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
C = 4


def _quiet(*a):
    pass


@pytest.mark.parametrize("w2,node_lo", [(4, 8), (8, 0)])
def test_histogram_matches_jax(rng, w2, node_lo):
    """Left/total counts of one (image block, proposal block, node block)
    equal the JAX trainer's matmul, segment-sum and from-bits paths."""
    depth, labels = fixtures.synthetic_hand_dataset(rng, n=2, h=16, w=24)
    nodes = rng.integers(0, 8, size=depth.shape).astype(np.int32)
    nodes[labels == 0] = -1
    props = make_random_features(12, rng)
    bits = train_feature_bits_plain(torch.as_tensor(depth),
                                    torch.as_tensor(props),
                                    torch.as_tensor(nodes >= 0))
    left, total = trainer.histogram_step(
        bits, torch.as_tensor(labels.astype(np.int32)), torch.as_tensor(nodes),
        num_classes=C, w2=w2, node_lo=node_lo, num_props=12)
    assert left.shape == (12, w2, C) and total.shape == (w2, C)
    assert total.sum() > 0
    kw = dict(num_classes=C, w2=w2, node_lo=node_lo, chunk=128)
    args = [jnp.asarray(a) for a in (depth, labels, nodes)]
    for use_matmul in (True, False):
        jl, jt = _histogram_step(*args, jnp.asarray(props),
                                 use_matmul=use_matmul, **kw)
        np.testing.assert_array_equal(left.numpy(), np.asarray(jl))
        np.testing.assert_array_equal(total.numpy(), np.asarray(jt))
    jl, jt = _histogram_step_from_bits(jnp.asarray(bits.numpy()), *args[1:],
                                       use_matmul=True, num_props=12, **kw)
    np.testing.assert_array_equal(left.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(total.numpy(), np.asarray(jt))


def _one_tree_inputs(rng):
    depth, labels = fixtures.synthetic_hand_dataset(rng, n=4, h=16, w=24)
    props = [[make_random_features(8, rng) for _ in range(2)]
             for _ in range(5)]
    return depth, labels, props


def _port_tree(depth, labels, props, **kw):
    ds = ArrayDataset(depth, labels, C, images_per_block=2)
    t = DecisionTreeTrainer(2, 8, max_nodes_per_block=4, device="cpu", **kw)
    t.allocate(ds, 16, 5)
    tree = DecisionTree(5, C)
    t.train(ds, tree, proposals_per_level=props)
    return tree.data


def test_one_tree_matches_jax_and_oracle(rng):
    """Two image blocks, two proposal blocks, node blocks of 4 from level 2
    on: the port's tree is byte-equal to the JAX trainer's and to the
    scalar oracle's."""
    depth, labels, props = _one_tree_inputs(rng)
    got = _port_tree(depth, labels, props)
    ds = JaxArrayDataset(depth, labels, C, images_per_block=2)
    jt = JaxTrainer(2, 8, max_nodes_per_block=4)
    jt.allocate(ds, 16, 5)
    want = JaxTree(5, C)
    jt.train(ds, want, proposals_per_level=props)
    assert got.tobytes() == want.data.tobytes()
    assert (got[:, 5:7] == -1).sum() >= 8           # the tree really splits
    assert (np.abs(got).sum(axis=1) > 0)[15:].any()  # ... down to level 4
    ref = oracle.train_tree(depth, labels,
                            [np.concatenate(p) for p in props], 5, C)
    assert got.tobytes() == ref.tobytes()


@pytest.mark.parametrize("codec", [True, False])
def test_streaming_matches_resident(rng, codec):
    depth, labels, props = _one_tree_inputs(rng)
    resident = _port_tree(depth, labels, props)
    streamed = _port_tree(depth, labels, props, streaming=True,
                          stream_codec=codec)
    assert streamed.tobytes() == resident.tobytes()


def _forest_data(rng):
    depth, labels = fixtures.synthetic_hand_dataset(rng, n=6, h=16, w=24)
    return depth[:4], labels[:4], depth[4:], labels[4:]


CFG = dict(num_random_features=16, proposals_per_block=8, images_per_block=2,
           max_tree_depth=4, trees_in_forest=2, trees_to_try=3)


def test_train_forest_matches_jax(rng):
    d_tr, l_tr, d_te, l_te = _forest_data(rng)
    want = jax_train_forest(
        JaxArrayDataset(d_tr, l_tr, C, images_per_block=2),
        JaxArrayDataset(d_te, l_te, C), rng=np.random.default_rng(3),
        log=_quiet, **CFG)
    got = driver.train_forest(
        ArrayDataset(d_tr, l_tr, C, images_per_block=2),
        ArrayDataset(d_te, l_te, C), rng=np.random.default_rng(3),
        log=_quiet, device="cpu", **CFG)
    assert got.data.shape == (2, 15, 15)
    assert got.data.tobytes() == want.data.tobytes()
    assert abs(got.pct_match - want.pct_match) <= 1e-12
    assert got.pct_match > 0.5


def test_train_forest_streaming_matches_resident(rng):
    d_tr, l_tr, d_te, l_te = _forest_data(rng)
    tr = ArrayDataset(d_tr, l_tr, C, images_per_block=2)
    te = ArrayDataset(d_te, l_te, C)
    kw = dict(log=_quiet, device="cpu", **CFG)
    a = driver.train_forest(tr, te, rng=np.random.default_rng(5), **kw)
    b = driver.train_forest(CompressedDataset(tr), te,
                            rng=np.random.default_rng(5), streaming=True, **kw)
    assert a.data.tobytes() == b.data.tobytes()
    assert a.pct_match == b.pct_match


def test_train_forest_checkpoint_resume(rng, tmp_path, monkeypatch):
    """A run that dies during candidate tree 2 and is relaunched gives the
    forest of an uninterrupted run (the rng state rides the checkpoint)."""
    d_tr, l_tr, d_te, l_te = _forest_data(rng)
    tr = ArrayDataset(d_tr, l_tr, C, images_per_block=2)
    te = ArrayDataset(d_te, l_te, C, images_per_block=1)
    kw = dict(log=_quiet, device="cpu", **CFG)
    want = driver.train_forest(tr, te, rng=np.random.default_rng(42), **kw)

    ck = str(tmp_path / "ck")
    calls = {"n": 0}
    real = driver.evaluate_tree_accuracy

    def dying_eval(*a, **k):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("simulated crash")
        return real(*a, **k)

    monkeypatch.setattr(driver, "evaluate_tree_accuracy", dying_eval)
    with pytest.raises(RuntimeError):
        driver.train_forest(tr, te, rng=np.random.default_rng(42),
                            checkpoint_dir=ck, **kw)
    monkeypatch.setattr(driver, "evaluate_tree_accuracy", real)
    assert os.path.exists(os.path.join(ck, "forest_ckpt.npz"))
    got = driver.train_forest(tr, te, rng=np.random.default_rng(42),
                              checkpoint_dir=ck, **kw)
    assert got.data.tobytes() == want.data.tobytes()
    assert got.pct_match == want.pct_match
    assert not os.path.exists(os.path.join(ck, "forest_ckpt.npz"))


def test_saved_forests_cross_load(rng, tmp_path):
    flat = fixtures.random_forest_flat(rng, 3, 4, 5)
    DecisionForest(3, 4, 5, flat.copy()).save(str(tmp_path / "port.npy"))
    JaxForest(3, 4, 5, flat.copy()).save(str(tmp_path / "jax.npy"))
    assert ((tmp_path / "port.npy").read_bytes()
            == (tmp_path / "jax.npy").read_bytes())
    j = JaxForest.load(str(tmp_path / "port.npy"))
    p = DecisionForest.load(str(tmp_path / "jax.npy"))
    assert (j.num_trees, j.max_depth, j.num_classes) == (3, 4, 5)
    assert (p.num_trees, p.max_depth, p.num_classes) == (3, 4, 5)
    assert j.data.tobytes() == p.data.tobytes() == flat.tobytes()
    trees = [DecisionTree(4, 5, flat[i].copy()) for i in range(3)]
    assert DecisionForest.from_trees(trees).data.tobytes() == flat.tobytes()


def _run_app(module, argv, monkeypatch, capsys):
    """Run an app's main() in this process with the global numpy rng (the
    dataset split's) seeded; returns its standard output."""
    monkeypatch.setattr(sys, "argv", [module.__file__, *argv])
    np.random.seed(0)
    module.main()
    return capsys.readouterr().out


def test_apps_match_jax(rng, tmp_path, monkeypatch, capsys):
    from apps import test_on_saved_model, test_on_saved_model_torch
    from apps import train_model, train_model_torch

    depth, labels = fixtures.synthetic_hand_dataset(rng, n=6, h=16, w=24)
    data = str(tmp_path / "ds")
    write_dataset(data, depth, labels, {1: [255, 0, 0, 255], 2: [0, 255, 0, 255],
                                        3: [0, 0, 255, 255]})
    args = ["-d", data, "--train", "4", "--train_block", "2", "--test", "2",
            "--proposals", "16", "--proposals_block", "8", "--out_trees", "2",
            "--trees_to_try", "3", "--depth", "4", "--seed", "7"]
    _run_app(train_model, args + ["-o", str(tmp_path / "jax.npy")],
             monkeypatch, capsys)
    out = _run_app(train_model_torch,
                   args + ["-o", str(tmp_path / "port.npy"), "--device", "cpu"],
                   monkeypatch, capsys)
    assert "FOREST pct. matching pixels" in out
    assert ((tmp_path / "port.npy").read_bytes()
            == (tmp_path / "jax.npy").read_bytes())

    ev = ["-m", str(tmp_path / "port.npy"), "-d", data, "--test", "6"]
    want = _run_app(test_on_saved_model, ev + ["-o", str(tmp_path / "rj")],
                    monkeypatch, capsys)
    got = _run_app(test_on_saved_model_torch,
                   ev + ["-o", str(tmp_path / "rp"), "--device", "cpu"],
                   monkeypatch, capsys)
    line = [l for l in got.splitlines() if "pct. matching" in l]
    assert line and line == [l for l in want.splitlines()
                             if "pct. matching" in l]
    for i in range(6):
        a = (tmp_path / "rp" / f"eval_labels_{i:08d}.png").read_bytes()
        assert a == (tmp_path / "rj" / f"eval_labels_{i:08d}.png").read_bytes()


def test_device_codec_matches_jax(rng):
    from beats3d_tpu.data import device_codec as jdc
    from beats3d_tpu_torch.data import device_codec as tdc

    _, labels = fixtures.synthetic_hand_dataset(rng, n=2, h=16, w=24)
    nodes = np.where(labels > 0, labels.astype(np.int32) * 3 - 1, -1)
    for arr, tdt in ((labels, torch.uint16), (nodes, torch.int32)):
        got = tdc.rle_encode(arr, 256)
        want = jdc.rle_encode(arr, 256)
        assert got[2:] == want[2:] and not got[3]
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        dec = tdc.rle_decode(torch.as_tensor(got[0]), torch.as_tensor(got[1]),
                             n=arr.size, shape=arr.shape, dtype=tdt)
        jdec = jdc.rle_decode(jnp.asarray(want[0]), jnp.asarray(want[1]),
                              n=arr.size, shape=arr.shape, dtype=str(arr.dtype))
        assert dec.dtype == tdt
        np.testing.assert_array_equal(dec.to(torch.int64).numpy(),
                                      np.asarray(jdec))
    noise = rng.integers(0, 60000, size=labels[0].shape).astype(np.uint16)
    store = tdc.DeviceCodecBlocks([labels[0], noise, labels[1]])
    assert len(store) == 3 and store._raw == [False, True, False]
    for i, want in enumerate((labels[0], noise, labels[1])):
        np.testing.assert_array_equal(
            store.get_block(i).to(torch.int64).numpy(), want)
    assert store.compression_ratio() > 1.0


def test_dataset_split_matches_jax(rng, tmp_path):
    from beats3d_tpu.data.dataset import DatasetConfig as JaxConfig
    from beats3d_tpu_torch.data.dataset import DatasetConfig

    depth, labels = fixtures.synthetic_hand_dataset(rng, n=6, h=12, w=16)
    write_dataset(str(tmp_path), depth, labels, {1: [9, 9, 9, 255]})
    subsets = [(4, 2, "train"), (2, None, "test")]
    for kw in (dict(rng=np.random.default_rng(1)), dict(ordered=True)):
        got = DatasetConfig.multiple(str(tmp_path), subsets, **kw)
        kw = dict(rng=np.random.default_rng(1)) if "rng" in kw else kw
        want = JaxConfig.multiple(str(tmp_path), subsets, **kw)
        for g, w in zip(got, want):
            assert g.image_idxes == w.image_idxes
            assert g.num_classes() == w.num_classes() == 2
            for b in range(g.num_image_blocks):
                np.testing.assert_array_equal(g.get_depth_block(b),
                                              w.get_depth_block(b))
                np.testing.assert_array_equal(g.get_labels_block(b),
                                              w.get_labels_block(b))
