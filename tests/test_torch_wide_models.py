"""Forests, layered models and trained forests past the widths the port's
kernels once refused (more than 16 trees or classes, more than 4 layers,
more than 128 condition rows), through the port on the CPU against the JAX
package on the CPU (XLA, as its FramePipeline picks off a TPU), on the same
inputs made from numpy seeds:

* evaluate_forest and forest_pdf_sum at T = 17 and 32 with C = 17: labels
  exact, sums bit-equal (the same level order);
* run_layered with 5 layers of 17 trees and 17 classes and 129 condition
  rows against JAX's XLA composite: labels exact;
* FramePipeline built from such a model (from the same numpy tables):
  labels, g_info and tip_valid exact, means atol 1e-3 px, heights rtol
  1e-5 (as tests/test_torch_pipeline.py);
* train_forest(trees_in_forest=17): trees byte-equal, pct_match equal.

The kernels themselves are held to these plain versions on the card by
tests/test_torch_cuda.py and chip_smoke.py."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fixtures

from beats3d_tpu.data.dataset import ArrayDataset as JaxArrayDataset
from beats3d_tpu.models import LayeredDecisionForest as JaxLayered
from beats3d_tpu.models.forest import PackedForest as JaxPacked
from beats3d_tpu.ops import forest_eval as jfe
from beats3d_tpu.runtime import pipeline as jpipe
from beats3d_tpu.train import train_forest as jax_train_forest
from beats3d_tpu.utils import CameraIntrinsics
from beats3d_tpu_torch import kernel_bench
from beats3d_tpu_torch.data.dataset import ArrayDataset
from beats3d_tpu_torch.models import LayeredDecisionForest
from beats3d_tpu_torch.ops import forest_eval_cuda
from beats3d_tpu_torch.runtime import pipeline as tpipe
from beats3d_tpu_torch.train import driver

H, W = 120, 212


@pytest.mark.parametrize("trees", [17, 32])
def test_wide_forest_labels_and_sums_match_jax(rng, trees):
    depth = fixtures.random_depth_image(rng, 2, 24, 40)
    flat = kernel_bench.random_forest(rng, trees, 6, 17)
    jt = JaxPacked.from_flat(flat).tables()
    for r, write_all in ((1, True), (2, False)):
        want = np.asarray(jfe.evaluate_forest(
            jnp.asarray(depth), jt, labels_reduce=r,
            write_all_eligible=write_all))
        got = forest_eval_cuda.evaluate_forest_cuda(
            torch.as_tensor(depth), torch.as_tensor(flat), labels_reduce=r,
            write_all_eligible=write_all)
        np.testing.assert_array_equal(got.numpy(), want)
        assert (want > 16).any() and (want < 16).any()
    w_pdf, w_elig, w_done = (np.asarray(a) for a in jfe.forest_pdf_sum(
        jnp.asarray(depth), jt, labels_reduce=1))
    pdf, elig, done = (t.numpy() for t in forest_eval_cuda.forest_pdf_sum_cuda(
        torch.as_tensor(depth.astype(np.int32)), torch.as_tensor(flat)))
    np.testing.assert_array_equal(elig, w_elig)
    np.testing.assert_array_equal(done, w_done)
    assert pdf.view(np.uint32).tobytes() == w_pdf.view(np.uint32).tobytes()


def _write_model(tmp_path, specs, cond, colors):
    """The wide model in the reference's artifact format (.npy forests and
    model_cfg.json), which both packages load."""
    layers = []
    for i, (flat, fm, fc) in enumerate(specs):
        np.save(os.path.join(tmp_path, f"m{i}.npy"), flat)
        layer = {"model": f"m{i}.npy"}
        if fm is not None:
            layer.update(filter_model=fm, filter_model_class=fc)
        layers.append(layer)
    path = os.path.join(tmp_path, "model_cfg.json")
    with open(path, "w") as f:
        json.dump({"layers": layers, "conditions": cond.tolist(),
                   "label_colors": colors.tolist()}, f)
    return path


def _wide_pair(tmp_path, seed, cond_rows=129):
    specs, cond, colors = kernel_bench.wide_layered(
        np.random.default_rng(seed), 5, 17, 17, cond_rows, 5)
    path = _write_model(str(tmp_path), specs, cond, colors)
    jm = JaxLayered.load(path, labels_reduce=2)
    assert not jm.pallas_supported()      # JAX sends it to the XLA composite
    return jm, LayeredDecisionForest.load(path, labels_reduce=2, device="cpu")


def test_wide_layered_matches_jax_xla(tmp_path, rng):
    jm, tm = _wide_pair(tmp_path, 21)
    assert len(tm.layers) == 5 and tm.conditions.shape == (129, 2)
    depth = fixtures.random_depth_image(rng, 2, 48, 80)
    want = np.asarray(jm.run(jnp.asarray(depth)))
    got = tm.run(torch.as_tensor(depth))
    np.testing.assert_array_equal(got.numpy(), want)
    # every layer labels some pixel, and the composite reaches row 128
    assert len(np.unique(want)) > 4


def _scene(intrin, t):
    h, w = intrin.height, intrin.width
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    depth = np.full((h, w), 2600.0, np.float32) - 0.5 * (yy - h / 2)
    for cx in (0.3 * w + 2 * t, 0.72 * w - 3 * t):
        blob = (xx - cx) ** 2 + (yy - h / 2 - t) ** 2 < 121
        depth[blob] -= 300.0 + 7.0 * t
    return depth.astype(np.uint16)


def _flat_plane():
    mat = np.eye(4, dtype=np.float32)
    mat[2, 3] = -2600.0
    mat[1, 2] = 0.0
    return mat


def test_wide_model_pipeline_matches_jax(tmp_path):
    """FramePipeline (the kernels' plain versions on the CPU) on the 5-layer
    wide model against JAX's FramePipeline(backend="xla"), frame by frame
    and batched."""
    jm, tm = _wide_pair(tmp_path, 22)
    intrin = CameraIntrinsics.d415(W, H)
    kw = dict(height=H, width=W, labels_reduce=2, crop_h=48, crop_w=64)
    jp = jpipe.FramePipeline(jm, intrin, cfg=jpipe.PipelineConfig(**kw),
                             group_min_size=0.01, backend="xla")
    tp = tpipe.FramePipeline(tm, intrin, cfg=tpipe.PipelineConfig(**kw),
                             group_min_size=0.01)
    plane = _flat_plane()
    frames = np.stack([_scene(intrin, t) for t in range(2)])
    for depth in frames:
        got = tp(depth, plane)
        want = jp(jnp.asarray(depth), jnp.asarray(plane))
        assert np.asarray(want["g_info"])[:, 0].min() > 0, "a hand is missing"
        _assert_outputs_match(got, want)
    got = tp.batch(frames, plane)
    want = jp.batch(jnp.asarray(frames), jnp.asarray(plane))
    _assert_outputs_match(got, want)


def _assert_outputs_match(got, want):
    for k in ("labels", "g_info", "tip_valid", "tip_px", "guard_muted"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    assert (got["labels"].numpy() != 65535).any()
    m_got, m_want = got["means"].numpy(), np.asarray(want["means"])
    np.testing.assert_array_equal(np.isnan(m_got), np.isnan(m_want))
    np.testing.assert_allclose(m_got, m_want, rtol=0, atol=1e-3)
    v = got["tip_valid"].numpy()
    np.testing.assert_allclose(got["heights"].numpy()[v],
                               np.asarray(want["heights"])[v], rtol=1e-5)


def test_train_forest_of_17_trees_matches_jax(rng):
    """train_forest(trees_in_forest=17): 17 candidate trees, the forest
    scored as a whole at the end (where B1 once refused 17 trees)."""
    depth, labels = fixtures.synthetic_hand_dataset(rng, n=6, h=12, w=16)
    cfg = dict(num_random_features=8, proposals_per_block=8,
               images_per_block=2, max_tree_depth=3, trees_in_forest=17)

    def quiet(*a):
        pass

    want = jax_train_forest(
        JaxArrayDataset(depth[:4], labels[:4], 4, images_per_block=2),
        JaxArrayDataset(depth[4:], labels[4:], 4),
        rng=np.random.default_rng(7), log=quiet, **cfg)
    got = driver.train_forest(
        ArrayDataset(depth[:4], labels[:4], 4, images_per_block=2),
        ArrayDataset(depth[4:], labels[4:], 4),
        rng=np.random.default_rng(7), log=quiet, device="cpu", **cfg)
    assert got.data.shape == (17, 7, 15)
    assert got.data.tobytes() == want.data.tobytes()
    assert got.pct_match == want.pct_match
