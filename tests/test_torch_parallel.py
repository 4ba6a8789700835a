"""The port's multi-device paths (beats3d_tpu_torch.parallel) on 4 gloo
ranks on the CPU, against the JAX package's on the first 4 of the 8 virtual
CPU devices of conftest.py, on the inputs of tests/test_parallel.py.

One spawn of 4 ranks per module runs every case in each rank
(``parallel.jobs.run_jobs``; the ranks import no JAX); the tests read its
results.  Labels, histograms and train-step outputs exact, trees
byte-equal, heights rtol 1e-5 / atol 1e-3 (mean shift sums in another
order, as in test_parallel.py).  Plus the dry run, a failing rank, and
apps/train_model_torch.py --mesh 2x2."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fixtures

from beats3d_tpu.data.dataset import ArrayDataset as JaxArrayDataset
from beats3d_tpu.models import LayeredDecisionForest as JaxLayered
from beats3d_tpu.models.forest import DecisionTree as JaxTree
from beats3d_tpu.models.forest import PackedForest as JaxPacked
from beats3d_tpu.ops import forest_eval as jax_forest_eval
from beats3d_tpu.parallel import evaluate_forest_sharded as jax_eval_sharded
from beats3d_tpu.parallel import make_mesh as jax_make_mesh
from beats3d_tpu.parallel import sharded_histogram_step as jax_hist_sharded
from beats3d_tpu.parallel import sharded_train_step as jax_step_sharded
from beats3d_tpu.runtime import pipeline as jpipe
from beats3d_tpu.train import DecisionTreeTrainer as JaxTrainer
from beats3d_tpu.train.trainer import _histogram_step, _pick_best_step
from beats3d_tpu.utils import CameraIntrinsics as JaxIntrinsics
from beats3d_tpu_torch.data.dataset import ArrayDataset, write_dataset
from beats3d_tpu_torch.models import LayeredDecisionForest
from beats3d_tpu_torch.models.forest import DecisionTree
from beats3d_tpu_torch.ops.train_features import train_feature_bits_plain
from beats3d_tpu_torch.parallel import jobs, launch
from beats3d_tpu_torch.parallel.dryrun import dryrun_multichip
from beats3d_tpu_torch.runtime import pipeline as tpipe
from beats3d_tpu_torch.train import DecisionTreeTrainer, make_random_features
from beats3d_tpu_torch.train import trainer
from beats3d_tpu_torch.utils.intrinsics import CameraIntrinsics

RANKS = 4
C = 4
H, W = 160, 256                 # batch_sharded's frames
TRAINER = dict(num_classes=C, proposals_per_block=8, num_random_features=16)
# the dry run's depth 3 in one streamed image block; a D=8 tree in two image
# blocks and node blocks of 8 (JAX's mesh trainer trains it in one node block
# per level: the blocks do not change the tree, and each block size costs
# JAX a compile per level)
TREES = {"depth3": dict(max_tree_depth=3, seed=5, images_per_block=4,
                        streaming=True),
         "d8": dict(max_tree_depth=8, seed=6, images_per_block=2,
                    max_nodes_per_block=8)}


def _rng():
    return np.random.default_rng(1234)      # conftest's rng fixture


def _eval_inputs():
    rng = _rng()
    return (fixtures.random_depth_image(rng, 8, 16, 24),
            fixtures.random_forest_flat(rng, 4, 4, 5))


def _step_inputs():
    rng = _rng()
    depth, labels = fixtures.synthetic_hand_dataset(rng, n=4, h=16, w=24)
    nodes = np.where(labels > 0, 0, -1).astype(np.int32)
    props = make_random_features(8, rng)
    parent = np.zeros((1, C), np.float32)
    for k in range(1, C):
        parent[0, k] = np.sum(labels == k)
    state = (np.array([0], np.int32), parent, np.full((1,), -1.0, np.float32),
             np.zeros((1, 5), np.float32), np.zeros((1, C), np.float32),
             np.zeros((1, C), np.float32))
    return depth, labels, nodes, props, state


def _frames():
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    frames = []
    for t in range(8):
        d = np.full((H, W), 2600.0, np.float32)
        r = int(0.12 * W)
        for cx in (int(0.25 * W) + 2 * t, int(0.75 * W) - t):
            d[(xx - cx) ** 2 + (yy - H / 2 - t) ** 2 < r * r] -= 300.0 + 4 * t
        frames.append(d.astype(np.uint16))
    plane = np.eye(4, dtype=np.float32)
    plane[2, 3] = -2600.0
    return np.stack(frames), plane


def _pipe_cfg():
    return dict(height=H, width=W, labels_reduce=2, crop_h=96, crop_w=128)


def _train_data():
    rng = np.random.default_rng(77)
    return fixtures.synthetic_hand_dataset(rng, n=4, h=16, w=24)


@pytest.fixture(scope="module")
def model_cfg(tmp_path_factory):
    return fixtures.layered_cfg_fixture(
        str(tmp_path_factory.mktemp("layered")), _rng())


@pytest.fixture(scope="module")
def ranks(model_cfg):
    """Every case, run once in each of 4 gloo ranks: {name: [(result,
    launches, bytes_reduced, seconds) per rank]}."""
    depth, forest = _eval_inputs()
    sd, sl, sn, sp, state = _step_inputs()
    frames, plane = _frames()
    td, tl = _train_data()
    step_kw = dict(num_classes=C, w2=1, node_lo=0)
    run = [
        ("mesh22", jobs.describe_job, (2, 2), {}),
        ("mesh41", jobs.describe_job, (4, 1), {}),
        ("eval", jobs.eval_job, (2, 2), dict(depth=depth, forest=forest)),
        ("eval_r2", jobs.eval_job, (2, 2), dict(
            depth=depth, forest=forest, labels_reduce=2, scale_factor=0.5)),
        ("hist", jobs.histogram_job, (2, 2), dict(
            depth=sd, labels=sl, nodes=sn, props=sp, **step_kw)),
        ("step", jobs.train_step_job, (2, 2), dict(
            depth=sd, labels=sl, nodes=sn, props=sp, state=state, **step_kw)),
        ("batch", jobs.batch_job, (4, 1), dict(
            model_cfg=model_cfg, intrin=CameraIntrinsics.d415(W, H),
            cfg=tpipe.PipelineConfig(**_pipe_cfg()), frames=frames,
            plane=plane, group_min_size=0.01)),
    ] + [(name, jobs.trainer_job, (2, 2), dict(depth=td, labels=tl,
                                               **TRAINER, **kw))
         for name, kw in TREES.items()]
    per_rank = launch.spawn(jobs.run_jobs, RANKS, device="cpu", args=(run,))
    return {name: [r[name] for r in per_rank] for name, *_ in run}


def _same_on_every_rank(results):
    first = results[0][0]
    for res, *_ in results[1:]:
        if isinstance(first, (tuple, list)):
            for a, b in zip(res, first):
                np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_array_equal(res, first)
    return first


@pytest.mark.parametrize("case,shape", [("mesh22", (2, 2)), ("mesh41", (4, 1))])
def test_make_mesh_shape_and_coords(ranks, case, shape):
    grid = np.arange(4).reshape(shape)
    for rank, (d, *_) in enumerate(ranks[case]):
        assert d["shape"] == {"data": shape[0], "model": shape[1]}
        assert d["grid"] == grid.tolist()
        i, j = np.argwhere(grid == rank)[0]
        assert d["coords"] == {"data": int(i), "model": int(j)}
        assert (d["backend"], d["device"]) == ("gloo", "cpu")


def _jax_eval(depth, forest, **kw):
    tables = JaxPacked.from_flat(forest).tables()
    mesh = jax_make_mesh(n_data=2, n_model=2)
    sharded = jax.jit(lambda d, t: jax_eval_sharded(d, t, mesh, **kw))
    return (np.asarray(jax_forest_eval.evaluate_forest(depth, tables, **kw)),
            np.asarray(sharded(jnp.asarray(depth), tables)))


@pytest.mark.parametrize("case,kw", [
    ("eval", {}), ("eval_r2", dict(labels_reduce=2, scale_factor=0.5))])
def test_eval_sharded_matches_single_and_jax(ranks, case, kw):
    """Frames over data, 2 trees per model shard: labels equal to one
    device's and to JAX's tree-sharded evaluation."""
    depth, forest = _eval_inputs()
    got = _same_on_every_rank(ranks[case])
    single, sharded = _jax_eval(depth, forest, **kw)
    np.testing.assert_array_equal(got, single)
    np.testing.assert_array_equal(got, sharded)
    assert (got != 65535).any() and (got == 65535).any()


def test_histogram_sharded_matches_jax(ranks):
    depth, labels, nodes, props, _ = _step_inputs()
    left, total = _same_on_every_rank(ranks["hist"])
    kw = dict(num_classes=C, w2=1, node_lo=0, chunk=256)
    args = [jnp.asarray(a) for a in (depth, labels, nodes, props)]
    jl, jt = jax_hist_sharded(*args, jax_make_mesh(n_data=2, n_model=2), **kw)
    wl, wt = _histogram_step(*args, use_matmul=True, **kw)
    for want_l, want_t in ((jl, jt), (wl, wt)):
        np.testing.assert_array_equal(left, np.asarray(want_l))
        np.testing.assert_array_equal(total, np.asarray(want_t))
    assert total.sum() > 0


def test_train_step_sharded_matches_jax(ranks):
    """The merged (gain, params, left, right) equal one device's step of the
    port bit for bit; against JAX's sharded step and JAX's single pick the
    params and counts are exact and the gain within JAX's own rtol 1e-6:
    JAX's CPU program contracts the gini sums into FMAs (ROADMAP C-w8), and
    a small gain is a difference of two impurities, here 4 ulp apart."""
    depth, labels, nodes, props, state = _step_inputs()
    got = _same_on_every_rank(ranks["step"])
    t = [torch.as_tensor(a) for a in (depth, labels, nodes, props)]
    bits = train_feature_bits_plain(t[0].to(torch.int32), t[3], t[2] >= 0)
    left, total = trainer.histogram_step(
        bits, t[1].to(torch.int32), t[2], num_classes=C, w2=1, node_lo=0,
        num_props=props.shape[0])
    st = [torch.as_tensor(a) for a in state]
    port = trainer.pick_best_step(st[0].to(torch.int64), st[1], left, total,
                                  t[3], *st[2:], w2=1, parent_lo=0)
    for g, w in zip(got, port):
        assert g.tobytes() == w.numpy().tobytes()
    kw = dict(num_classes=C, w2=1, node_lo=0, chunk=256)
    args = [jnp.asarray(a) for a in (depth, labels, nodes, props)]
    jstate = [jnp.asarray(a) for a in state]
    sharded = jax_step_sharded(*args, *jstate,
                               jax_make_mesh(n_data=2, n_model=2), **kw)
    lw, tw = _histogram_step(*args, use_matmul=True, **kw)
    single = _pick_best_step(jstate[0], jstate[1], lw, tw, args[3],
                             *jstate[2:], w2=1, parent_lo=0)
    for want in (sharded, single):
        np.testing.assert_allclose(got[0], np.asarray(want[0]), rtol=1e-6)
        for g, w in zip(got[1:], want[1:]):
            assert g.tobytes() == np.asarray(w).tobytes()
    assert got[0][0] > 0


def test_batch_sharded_matches_jax_and_batch(ranks, model_cfg):
    """4x1: each rank runs 2 of the 8 frames; every output equal to the
    port's .batch on all 8 and to JAX's batch_sharded."""
    frames, plane = _frames()
    got = ranks["batch"][0][0]
    for res, *_ in ranks["batch"][1:]:
        for k in got:
            np.testing.assert_array_equal(res[k], got[k])
    tp = tpipe.FramePipeline(
        LayeredDecisionForest.load(model_cfg, labels_reduce=2, device="cpu"),
        CameraIntrinsics.d415(W, H), cfg=tpipe.PipelineConfig(**_pipe_cfg()),
        group_min_size=0.01)
    jp = jpipe.FramePipeline(
        JaxLayered.load(model_cfg, labels_reduce=2), JaxIntrinsics.d415(W, H),
        cfg=jpipe.PipelineConfig(**_pipe_cfg()), group_min_size=0.01)
    mesh = jax_make_mesh(n_data=4, n_model=1)
    jfn = jax.jit(lambda f, p: jp.batch_sharded(f, p, mesh))
    wants = [{k: v.numpy() for k, v in tp.batch(frames, plane).items()},
             jax.tree.map(np.asarray, jfn(jnp.asarray(frames), jnp.asarray(plane)))]
    for want in wants:
        for k in ("labels", "g_info", "tip_valid", "tip_px"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        np.testing.assert_allclose(got["heights"], want["heights"],
                                   rtol=1e-5, atol=1e-3)
    assert got["labels"].shape == (8, 2, H // 2, W // 2)
    assert got["tip_valid"].any()


@pytest.fixture
def jitted_jax_histogram(monkeypatch):
    """JAX's mesh trainer calls its shard_map histogram eagerly (~4 s a
    level here): run it jitted, one program per static arguments."""
    from beats3d_tpu.parallel import train_sharded as jax_train_sharded

    eager = jax_train_sharded.sharded_histogram_step
    programs = {}

    def step(depth, labels, nodes, props, mesh, **kw):
        key = (mesh, tuple(sorted(kw.items())))
        if key not in programs:
            programs[key] = jax.jit(
                lambda d, l, n, p: eager(d, l, n, p, mesh, **kw))
        return programs[key](depth, labels, nodes, props)

    monkeypatch.setattr(jax_train_sharded, "sharded_histogram_step", step)


@pytest.mark.parametrize("case", list(TREES))
def test_mesh_trainer_matches_jax_and_single_rank(ranks, case,
                                                  jitted_jax_histogram):
    """The mesh DecisionTreeTrainer on 2x2 (each rank 1 or 2 images of each
    block, 4 of the 8 proposals of each block) writes, on every rank, the
    tree of the port's single-rank trainer and that of JAX's mesh trainer,
    byte for byte."""
    kw = dict(TREES[case])
    d, seed, ipb = (kw.pop(k) for k in ("max_tree_depth", "seed",
                                        "images_per_block"))
    depth, labels = _train_data()
    got = _same_on_every_rank(ranks[case])
    ppb, nrf = TRAINER["proposals_per_block"], TRAINER["num_random_features"]
    single = DecisionTree(d, C)
    ds = ArrayDataset(depth, labels, C, images_per_block=ipb)
    trainer = DecisionTreeTrainer(ipb, ppb, device="cpu", **kw)
    trainer.allocate(ds, nrf, d)
    trainer.train(ds, single, rng=np.random.default_rng(seed))
    assert got.tobytes() == single.data.tobytes()
    kw.pop("max_nodes_per_block", None)
    jds = JaxArrayDataset(depth, labels, C, images_per_block=ipb)
    jt = JaxTrainer(ipb, ppb, mesh=jax_make_mesh(n_data=2, n_model=2), **kw)
    jt.allocate(jds, nrf, d)
    want = JaxTree(d, C)
    jt.train(jds, want, rng=np.random.default_rng(seed))
    assert got.tobytes() == want.data.tobytes()
    assert (np.floor(got[:, 5:7]) == -1).sum() >= 3       # it really splits
    assert [l["B4"] for _, l, _, _ in ranks[case]] == [0] * RANKS  # CPU
    assert min(b for _, _, b, _ in ranks[case]) > 0       # it reduced


def test_dryrun_multichip_cpu(capfd):
    dryrun_multichip(4, "cpu")
    out = capfd.readouterr().out
    assert "dryrun_multichip OK on 4 devices (mesh data=2 model=2)" in out
    assert "[4 ranks, gloo, cpu]" in out


def test_failing_rank_raises_with_its_traceback():
    depth, forest = _eval_inputs()
    bad = [("bad", jobs.eval_job, (2, 1), dict(depth=depth[:3], forest=forest))]
    with pytest.raises(Exception, match="does not divide"):
        launch.spawn(jobs.run_jobs, 2, device="cpu", args=(bad,))


def test_train_app_mesh_matches_single_rank(tmp_path, monkeypatch):
    """apps/train_model_torch.py --mesh 2x2 spawns 4 gloo ranks and writes
    the .npy of a single-rank run."""
    from apps import train_model_torch

    depth, labels = fixtures.synthetic_hand_dataset(_rng(), n=6, h=16, w=24)
    data = str(tmp_path / "ds")
    write_dataset(data, depth, labels, {1: [255, 0, 0, 255],
                                        2: [0, 255, 0, 255],
                                        3: [0, 0, 255, 255]})
    args = ["-d", data, "--train", "4", "--train_block", "2", "--test", "2",
            "--proposals", "16", "--proposals_block", "8", "--out_trees", "2",
            "--trees_to_try", "3", "--depth", "4", "--seed", "7",
            "--device", "cpu"]
    for name, extra in (("one", []), ("mesh", ["--mesh", "2x2"])):
        monkeypatch.setattr(sys, "argv", [train_model_torch.__file__, *args,
                                          "-o", str(tmp_path / f"{name}.npy"),
                                          *extra])
        np.random.seed(0)                    # the dataset split's global rng
        train_model_torch.main()
    one = (tmp_path / "one.npy").read_bytes()
    assert one == (tmp_path / "mesh.npy").read_bytes()
    assert os.path.getsize(tmp_path / "one.npy") > 0
    assert torch.from_numpy(np.load(tmp_path / "one.npy")).abs().sum() > 0
