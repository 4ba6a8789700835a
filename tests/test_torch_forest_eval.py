"""The port's forest evaluation (beats3d_tpu_torch.ops.forest_eval and the
layered model) against the JAX package on the same seeded inputs: the XLA
evaluator on the CPU, the fused Pallas kernel in interpret mode, and the
flagship golden.  Labels must be exact.

The CUDA kernel itself (forest_eval_cuda) is checked on the card by
tests/test_torch_cuda.py and chip_smoke.py; on the CPU its wrapper runs the
plain version tested here."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fixtures
import oracle

from beats3d_tpu.models import LayeredDecisionForest as JaxLayered
from beats3d_tpu.models.forest import PackedForest as JaxPacked
from beats3d_tpu.ops import forest_eval as jfe
from beats3d_tpu.ops import forest_eval_pallas as fep
from beats3d_tpu_torch.models import LayeredDecisionForest
from beats3d_tpu_torch.models.forest import (DecisionForest, PackedForest,
                                             kernel_tables)
from beats3d_tpu_torch.models.layered import run_layered
from beats3d_tpu_torch.ops import forest_eval, forest_eval_cuda

HERE = os.path.dirname(os.path.abspath(__file__))
FLAGSHIP = os.path.join(os.path.dirname(HERE), "models", "flagship")


def _tables(flat):
    return PackedForest.from_flat(torch.as_tensor(flat)).tables()


@pytest.mark.parametrize("r,scale", [(1, 1.0), (2, 1.0), (2, 0.5), (1, 0.25)])
def test_evaluate_forest_matches_jax(rng, r, scale):
    depth = fixtures.random_depth_image(rng, 2, 24, 32)
    flat = fixtures.random_forest_flat(rng, 3, 5, 5)
    want = np.asarray(jfe.evaluate_forest(
        jnp.asarray(depth), JaxPacked.from_flat(flat).tables(),
        labels_reduce=r, scale_factor=scale))
    got = forest_eval.evaluate_forest(
        torch.as_tensor(depth), _tables(flat), labels_reduce=r,
        scale_factor=scale)
    assert got.dtype == torch.uint16
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        want, oracle.eval_forest(depth, flat, 5, 5, labels_reduce=r,
                                 scale_factor=scale))


def test_filter_and_single_tree_semantics(rng):
    depth = fixtures.random_depth_image(rng, 1, 24, 32)
    flat = fixtures.random_forest_flat(rng, 2, 4, 5)
    filt = rng.integers(0, 3, size=(1, 12, 16)).astype(np.uint16)
    want = np.asarray(jfe.evaluate_forest(
        jnp.asarray(depth), JaxPacked.from_flat(flat).tables(),
        labels_reduce=2, filter_images=jnp.asarray(filt), filter_class=1))
    got = forest_eval.evaluate_forest(
        torch.as_tensor(depth), _tables(flat), labels_reduce=2,
        filter_images=torch.as_tensor(filt), filter_class=1)
    np.testing.assert_array_equal(got.numpy(), want)

    tree = fixtures.random_tree_flat(rng, 5, 4)
    want = np.asarray(jfe.evaluate_tree(
        jnp.asarray(depth), JaxPacked.from_flat(tree[None]).tables()))
    got = forest_eval.evaluate_forest(
        torch.as_tensor(depth), _tables(tree[None]), write_all_eligible=False)
    np.testing.assert_array_equal(got.numpy(), want)


def test_composite_labels_matches_jax(rng):
    labels = rng.integers(0, 5, size=(3, 2, 10, 12)).astype(np.uint16)
    labels[rng.random(labels.shape) < 0.1] = 65535
    conditions = np.array(
        [[1, 4], [0, 1], [0, 2], [1, 7], [0, 3], [2, 0], [0, 4], [0, 5],
         [1, 0]], np.int32)
    want = np.asarray(jfe.composite_labels(
        jnp.asarray(labels), jnp.asarray(conditions)))
    got = forest_eval.composite_labels(
        torch.as_tensor(labels), torch.as_tensor(conditions))
    np.testing.assert_array_equal(got.numpy(), want)


def _layered_pair(tmp_path, rng, r):
    cfg_path = fixtures.layered_cfg_fixture(str(tmp_path), rng)
    return (JaxLayered.load(cfg_path, labels_reduce=r),
            LayeredDecisionForest.load(cfg_path, labels_reduce=r, device="cpu"))


@pytest.mark.parametrize("h,w,r,scale", [(24, 32, 2, 1.0), (32, 256, 2, 0.25),
                                         (24, 32, 1, 0.5)])
def test_layered_matches_jax_xla(tmp_path, rng, h, w, r, scale):
    jm, tm = _layered_pair(tmp_path, rng, r)
    depth = fixtures.random_depth_image(rng, 2, h, w)
    want = np.asarray(jm.run(jnp.asarray(depth), scale_factor=scale))
    got = tm.run(torch.as_tensor(depth), scale_factor=scale)
    np.testing.assert_array_equal(got.numpy(), want)


def test_layered_matches_pallas_interpret(tmp_path, rng):
    """The fused Pallas kernel (interpret mode) that K1 replaces."""
    jm, tm = _layered_pair(tmp_path, rng, 2)
    depth = fixtures.random_depth_image(rng, 1, 24, 32)
    want = np.asarray(fep.evaluate_layered_pallas(
        jnp.asarray(depth), jm.layer_tables_pallas(), jm.layer_metas(),
        jm.conditions_packed(), int(jm.conditions_np.shape[0]),
        filter_specs=tuple((l.filter_model, l.filter_model_class)
                           for l in jm.layers),
        labels_reduce=2, scale_factor=0.5, interpret=True))
    got = tm.run(torch.as_tensor(depth), scale_factor=0.5)
    np.testing.assert_array_equal(got.numpy(), want)


def test_from_numpy_equals_load(tmp_path, rng):
    cfg_path = fixtures.layered_cfg_fixture(str(tmp_path), rng)
    jm = JaxLayered.load(cfg_path, labels_reduce=2)
    a = LayeredDecisionForest.from_numpy(
        [(l.flat, l.filter_model, l.filter_model_class) for l in jm.layers],
        jm.conditions_np, jm.label_colors, "cpu", labels_reduce=2)
    b = LayeredDecisionForest.load(cfg_path, labels_reduce=2, device="cpu")
    assert a.num_layered_classes == b.num_layered_classes == jm.num_layered_classes
    assert a.filter_specs() == b.filter_specs() == tuple(
        (l.filter_model, l.filter_model_class) for l in jm.layers)
    for la, lb in zip(a.layers, b.layers):
        assert torch.equal(la.flat, lb.flat)
    depth = torch.as_tensor(fixtures.random_depth_image(rng, 1, 24, 32))
    assert torch.equal(a.run(depth), b.run(depth))


def test_forest_npy_roundtrip(tmp_path, rng):
    flat = fixtures.random_forest_flat(rng, 3, 5, 6)
    path = str(tmp_path / "f.npy")
    np.save(path, flat)
    f = DecisionForest.load(path)
    assert (f.num_trees, f.max_depth, f.num_classes) == (3, 5, 6)
    packed = PackedForest.from_flat(torch.as_tensor(f.data))
    jax_levels = JaxPacked.from_flat(flat).levels
    for lt, lj in zip(packed.levels, jax_levels):
        for a, b in ((lt.uv, lj.uv), (lt.thresh, lj.thresh),
                     (lt.lr_next, lj.lr_next), (lt.pdf, lj.pdf)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_wrapper_on_cpu_is_the_plain_version(tmp_path, rng):
    cfg_path = fixtures.layered_cfg_fixture(str(tmp_path), rng)
    tm = LayeredDecisionForest.load(cfg_path, labels_reduce=2, device="cpu")
    depth = torch.as_tensor(fixtures.random_depth_image(rng, 2, 24, 32))
    before = forest_eval_cuda.evaluate_layered_cuda.launches
    got = forest_eval_cuda.evaluate_layered_cuda(
        depth.to(torch.int32), tm.layers, tm.conditions, labels_reduce=2)
    want = forest_eval_cuda.evaluate_layered_plain(
        depth, tm.layers, tm.conditions, labels_reduce=2)
    assert forest_eval_cuda.evaluate_layered_cuda.launches == before
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_flagship_golden_labels():
    """The committed D=16 flagship at r=2 through the plain evaluator equals
    golden_eval.npz frame 0 (recorded at r=1) subsampled, exactly."""
    data = np.load(os.path.join(FLAGSHIP, "golden_eval.npz"))
    model = LayeredDecisionForest.load(
        os.path.join(FLAGSHIP, "model_cfg.json"), labels_reduce=2,
        device="cpu")
    got = model.run(torch.as_tensor(data["depth"][:1]))
    np.testing.assert_array_equal(got[0].numpy(), data["labels"][0][::2, ::2])


def test_evaluate_tree_matches_jax(rng):
    depth = fixtures.random_depth_image(rng, 2, 24, 32)
    tree = fixtures.random_tree_flat(rng, 6, 5, leaf_prob=0.15)
    tree[31:, 5] = -1.0     # last-level left sides descend: walks not done
    want = np.asarray(jfe.evaluate_tree(
        jnp.asarray(depth), JaxPacked.from_flat(tree[None]).tables()))
    got = forest_eval.evaluate_tree(torch.as_tensor(depth), _tables(tree[None]))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want == 65535).sum() > (depth == 0).sum() + (depth == 65535).sum()


@pytest.mark.parametrize("r,write_all", [(1, False), (2, True)])
def test_forest_wrapper_cpu_path_matches_pallas(rng, r, write_all):
    """evaluate_forest_cuda on CPU tensors (its plain version) against the
    Pallas kernel B1 replaces, in interpret mode, with a filter image."""
    depth = fixtures.random_depth_image(rng, 2, 16, 24)
    flat = fixtures.random_forest_flat(rng, 2, 4, 4, leaf_prob=0.2)
    filt = rng.integers(0, 3, size=(2, 16 // r, 24 // r)).astype(np.int32)
    tables, meta = fep.pack_tables_pallas(flat)
    k = forest_eval_cuda.evaluate_forest_cuda
    for scale in (1.0, 0.5):
        want = np.asarray(fep.evaluate_forest_pallas(
            jnp.asarray(depth), tables, meta, labels_reduce=r,
            filter_images=jnp.asarray(filt), filter_class=1,
            scale_factor=scale, write_all_eligible=write_all, interpret=True))
        before = k.launches
        got = k(torch.as_tensor(depth.astype(np.int32)), torch.as_tensor(flat),
                labels_reduce=r, filter_images=torch.as_tensor(filt),
                filter_class=1, scale_factor=scale,
                write_all_eligible=write_all)
        assert k.launches == before
        np.testing.assert_array_equal(got.numpy(), want)
        assert ((want != 65535) & (want != 0)).any()


def test_flagship_fine_forest_single_matches_jax():
    """The committed flagship's fine layer (D=16, T=4, C=7) evaluated alone
    on the golden depth frames, plain path against the JAX evaluator."""
    data = np.load(os.path.join(FLAGSHIP, "golden_eval.npz"))
    flat = DecisionForest.load(os.path.join(FLAGSHIP, "m1.npy")).data
    assert flat.shape == (4, 65535, 21)
    depth = data["depth"][:1]
    want = np.asarray(jfe.evaluate_forest(
        jnp.asarray(depth), JaxPacked.from_flat(flat).tables(),
        labels_reduce=2))
    got = forest_eval_cuda.evaluate_forest_cuda(
        torch.as_tensor(depth.astype(np.int32)), torch.as_tensor(flat),
        labels_reduce=2)
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(np.unique(want)) >= 5


def test_run_live_frame_matches_jax(rng):
    """apps/run_live_torch.py's frame function against the JAX app's on one
    synthetic 848x480 frame."""
    from apps import run_live, run_live_torch
    from beats3d_tpu_torch.data.synth import articulated_scene
    from beats3d_tpu_torch.utils import CameraIntrinsics

    intrin = CameraIntrinsics.d415()
    depth, _ = articulated_scene(intrin, np.random.default_rng(2000))
    flat = fixtures.random_forest_flat(rng, 2, 6, 7, off_mag=60000.0)
    mat = np.eye(4, dtype=np.float32)
    mat[2, 3] = -2600.0
    want = np.asarray(run_live._frame(
        jnp.asarray(depth), jnp.asarray(mat), jnp.asarray(intrin.pp),
        jnp.float32(intrin.fx), JaxPacked.from_flat(flat).tables(),
        jnp.float32(40.0)))
    got = run_live_torch.frame_labels(
        torch.as_tensor(depth.astype(np.int32)), torch.as_tensor(mat),
        intrin.pp, intrin.fx, torch.as_tensor(flat), 40.0)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want == 65535).any() and (want != 65535).sum() > 10000


def _bits(t):
    return t.contiguous().view(torch.int32)


def flat_from_kernel_tables(header, pdf):
    """The dense forest that kernel_tables repacked."""
    t, nodes, _, c = pdf.shape
    return torch.cat([header[..., :7], pdf.reshape(t, nodes, 2 * c)], dim=-1)


@pytest.mark.parametrize("t,d,c", [(3, 5, 5), (1, 4, 2), (5, 6, 16)])
def test_kernel_tables_roundtrip(rng, t, d, c):
    """The layered kernel's repacking: 32-byte headers, the pdf table read
    at the leaves, and back to the dense forest bit for bit."""
    flat = torch.as_tensor(fixtures.random_forest_flat(rng, t, d, c))
    header, pdf = kernel_tables(flat)
    assert header.shape == (t, 2 ** d - 1, 8) and header.dtype == torch.float32
    assert header.is_contiguous() and header[0, 0].numel() * 4 == 32
    assert pdf.shape == (t, 2 ** d - 1, 2, c) and pdf.is_contiguous()
    assert torch.equal(_bits(header[..., 7]), torch.zeros_like(_bits(header[..., 7])))
    assert torch.equal(_bits(header[..., :7]), _bits(flat[..., :7]))
    assert torch.equal(_bits(pdf[:, :, 0]), _bits(flat[..., 7:7 + c]))
    assert torch.equal(_bits(pdf[:, :, 1]), _bits(flat[..., 7 + c:]))
    assert torch.equal(_bits(flat_from_kernel_tables(header, pdf)), _bits(flat))


def test_kernel_tables_flagship_roundtrip():
    """Both flagship layers (D=8 T=4 C=2, D=16 T=4 C=7) as the model holds
    them after load."""
    model = LayeredDecisionForest.load(
        os.path.join(FLAGSHIP, "model_cfg.json"), device="cpu")
    for l in model.layers:
        assert torch.equal(_bits(flat_from_kernel_tables(l.header, l.pdf)),
                           _bits(l.flat))
    assert model.layers[1].header.shape == (4, 65535, 8)
    assert model.layers[1].pdf.shape == (4, 65535, 2, 7)


def _oracle_layered(jm, depth, r, scale):
    layer_labels = []
    for l in jm.layers:
        kw = dict(labels_reduce=r, scale_factor=scale)
        if l.filter_model is not None:
            kw.update(filter_images=layer_labels[l.filter_model],
                      filter_class=l.filter_model_class)
        t, nodes, els = l.flat.shape
        layer_labels.append(oracle.eval_forest(
            depth, l.flat, int(np.log2(nodes + 1)), (els - 7) // 2, **kw))
    return np.stack([oracle.composite_labels([ll[i] for ll in layer_labels],
                                             jm.conditions_np)
                     for i in range(depth.shape[0])])


@pytest.mark.parametrize("h,w,r,scale", [(24, 32, 2, 1.0), (20, 36, 1, 0.5),
                                         (26, 40, 2, 0.25)])
def test_layered_from_jax_params_matches_xla_and_oracle(tmp_path, rng, h, w,
                                                        r, scale):
    """run_layered on a CPU model built from the JAX model's parameters
    (which builds the kernel's tables too) against JAX's evaluate_layered on
    the XLA path and against tests/oracle.py: labels bit-exact."""
    cfg_path = fixtures.layered_cfg_fixture(str(tmp_path), rng)
    jm = JaxLayered.load(cfg_path, labels_reduce=r)
    tm = LayeredDecisionForest.from_numpy(
        [(l.flat, l.filter_model, l.filter_model_class) for l in jm.layers],
        jm.conditions_np, jm.label_colors, "cpu", labels_reduce=r)
    for l, jl in zip(tm.layers, jm.layers):
        h_, p_ = kernel_tables(torch.as_tensor(np.asarray(jl.flat)))
        assert torch.equal(_bits(l.header), _bits(h_))
        assert torch.equal(_bits(l.pdf), _bits(p_))
    depth = fixtures.random_depth_image(rng, 2, h, w)
    want = np.asarray(jm.run(jnp.asarray(depth), scale_factor=scale))
    got = run_layered(torch.as_tensor(depth), tm, labels_reduce=r,
                      scale_factor=scale)
    assert tm.kernel_descs is None          # the CPU path builds none
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, _oracle_layered(jm, depth, r, scale))
    assert ((want != 65535) & (want != 0)).any()
