"""The port's hand-written CUDA kernels against their plain PyTorch versions
on the card.  Every test here is marked ``cuda`` and skips without an NVIDIA
card, so the CPU run collects and skips them.  The file imports no JAX, so
it also runs where JAX is absent:

    python -m pytest tests/test_torch_cuda.py -q --noconftest
"""

import os

import numpy as np
import pytest
import torch

import fixtures

from beats3d_tpu_torch.models import LayeredDecisionForest
from beats3d_tpu_torch.ops import (forest_eval_cuda, points, preproc_cuda,
                                   train_features, train_features_cuda)
from beats3d_tpu_torch.train.proposals import make_random_features

HERE = os.path.dirname(os.path.abspath(__file__))
FLAGSHIP = os.path.join(os.path.dirname(HERE), "models", "flagship")


@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("CUDA kernel test: needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.fixture
def rng_np():
    return np.random.default_rng(1234)


@pytest.mark.cuda
@pytest.mark.parametrize("scale,r", [(1.0, 2), (0.5, 2), (0.25, 1)])
def test_layered_kernel_matches_plain(tmp_path, rng_np, cuda_dev, scale, r):
    cfg_path = fixtures.layered_cfg_fixture(str(tmp_path), rng_np)
    m = LayeredDecisionForest.load(cfg_path, labels_reduce=r, device=cuda_dev)
    depth = torch.as_tensor(fixtures.random_depth_image(rng_np, 3, 48, 96))
    depth = depth.to(cuda_dev).to(torch.int32).contiguous()
    before = forest_eval_cuda.evaluate_layered_cuda.launches
    got = forest_eval_cuda.evaluate_layered_cuda(
        depth, m.layers, m.conditions, labels_reduce=r, scale_factor=scale)
    want = forest_eval_cuda.evaluate_layered_plain(
        depth, m.layers, m.conditions, labels_reduce=r, scale_factor=scale)
    torch.cuda.synchronize()
    assert forest_eval_cuda.evaluate_layered_cuda.launches == before + 1
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())


@pytest.mark.cuda
def test_layered_kernel_flagship_golden(cuda_dev):
    data = np.load(os.path.join(FLAGSHIP, "golden_eval.npz"))
    m = LayeredDecisionForest.load(os.path.join(FLAGSHIP, "model_cfg.json"),
                                   labels_reduce=2, device=cuda_dev)
    depth = torch.as_tensor(data["depth"]).to(cuda_dev).to(torch.int32)
    got = m.run(depth.contiguous())
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  data["labels"][:, ::2, ::2])


@pytest.mark.cuda
def test_layered_kernel_rejects_bad_input(tmp_path, rng_np, cuda_dev):
    cfg_path = fixtures.layered_cfg_fixture(str(tmp_path), rng_np)
    m = LayeredDecisionForest.load(cfg_path, labels_reduce=2, device=cuda_dev)
    depth = torch.zeros((1, 16, 16), dtype=torch.int16, device=cuda_dev)
    with pytest.raises(ValueError):
        forest_eval_cuda.evaluate_layered_cuda(
            depth, m.layers, m.conditions, labels_reduce=2)


@pytest.mark.cuda
def test_preproc_kernel_matches_plain(rng_np, cuda_dev):
    d = fixtures.random_depth_image(rng_np, 3, 40, 136, missing_frac=0.15,
                                    far_frac=0.0)
    d = np.where(d > 0, (d % 400) + 2350, 0).astype(np.uint16)
    d[:, 8:16, :] = 2500
    depth = torch.as_tensor(d).to(cuda_dev).to(torch.int32).contiguous()
    mat = torch.eye(4, device=cuda_dev)
    mat[2, 3] = -2600.0
    pp = np.array([64.0, 24.0], np.float32)
    got = preproc_cuda.plane_band_gauss_cuda(depth, mat, pp, 180.0, 40.0)
    want = preproc_cuda.plane_band_gauss_plain(depth, mat, pp, 180.0, 40.0)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())
    assert got.cpu().numpy().any()


@pytest.mark.cuda
def test_preproc_kernel_single_frame_and_dtype(cuda_dev):
    d = np.full((32, 128), 2500, np.uint16)
    d[:16, :] = 2599
    depth = torch.as_tensor(d).to(cuda_dev).to(torch.int32).contiguous()
    mat = torch.eye(4, device=cuda_dev)
    mat[2, 3] = -2600.0
    pp = np.array([16.0, 16.0], np.float32)
    got = preproc_cuda.plane_band_gauss_cuda(depth, mat, pp, 150.0, 40.0)
    assert got.shape == depth.shape and got.dtype == torch.int32
    want = points.gaussian_depth_filter(
        points.plane_band_depth(depth, mat, pp, 150.0, 40.0),
        points.gaussian_kernel(5, 2.0))
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())
    with pytest.raises(ValueError):
        preproc_cuda.plane_band_gauss_cuda(depth.to(torch.int64), mat, pp,
                                           150.0, 40.0)


def _b4_inputs(rng_np, dev, p):
    depth = fixtures.random_depth_image(rng_np, 3, 40, 72)
    depth[0, 5, 7] = 0          # a zero centre
    depth[1, 0, 0] = 65535      # a sentinel centre
    props = make_random_features(p, rng_np)
    props[0, 0:2] = (1.0e6, -1.0e6)   # probes far out of bounds
    active = rng_np.random(depth.shape) < 0.6
    return (torch.as_tensor(depth).to(dev).to(torch.int32).contiguous(),
            torch.as_tensor(props).to(dev),
            torch.as_tensor(active).to(dev))


@pytest.mark.cuda
@pytest.mark.parametrize("p", [1, 32, 33, 64])
def test_train_bits_kernel_matches_plain(rng_np, cuda_dev, p):
    depth, props, active = _b4_inputs(rng_np, cuda_dev, p)
    k = train_features_cuda.train_feature_bits_cuda
    before = k.launches
    for act in (None, active):
        got = k(depth, props, act)
        want = train_features.train_feature_bits_plain(depth, props, act)
        torch.cuda.synchronize()
        assert got.shape == (3, (p + 31) // 32, 40, 72)
        np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())
    assert k.launches == before + 2
    assert got.cpu().numpy().any()


@pytest.mark.cuda
def test_train_bits_kernel_rejects_bad_input(rng_np, cuda_dev):
    depth, props, active = _b4_inputs(rng_np, cuda_dev, 8)
    k = train_features_cuda.train_feature_bits_cuda
    with pytest.raises(ValueError):
        k(depth.to(torch.int64), props)
    with pytest.raises(ValueError):
        k(depth, props.cpu())
    with pytest.raises(ValueError):
        k(depth, props, active.to(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("r,scale,filtered,write_all", [
    (1, 1.0, False, True), (2, 1.0, True, True), (2, 0.5, True, False),
    (1, 0.5, False, False), (2, 0.25, False, True)])
def test_forest_kernel_matches_plain(rng_np, cuda_dev, r, scale, filtered,
                                     write_all):
    flat = torch.as_tensor(fixtures.random_forest_flat(rng_np, 3, 6, 5))
    flat = flat.to(cuda_dev).contiguous()
    depth = torch.as_tensor(fixtures.random_depth_image(rng_np, 2, 48, 96))
    depth = depth.to(cuda_dev).to(torch.int32).contiguous()
    kw = dict(labels_reduce=r, scale_factor=scale, write_all_eligible=write_all)
    if filtered:
        filt = rng_np.integers(0, 3, size=(2, 48 // r, 96 // r))
        kw.update(filter_images=torch.as_tensor(filt).to(cuda_dev).to(torch.int32),
                  filter_class=1)
    k = forest_eval_cuda.evaluate_forest_cuda
    before = k.launches
    got = k(depth, flat, **kw)
    want = forest_eval_cuda.evaluate_forest_plain(depth, flat, **kw)
    torch.cuda.synchronize()
    assert k.launches == before + 1
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())
    assert (got.cpu().numpy() != 65535).any()


@pytest.mark.cuda
def test_forest_kernel_rejects_bad_input(rng_np, cuda_dev):
    flat = torch.as_tensor(fixtures.random_forest_flat(rng_np, 2, 4, 5))
    depth = torch.zeros((1, 16, 16), dtype=torch.int32, device=cuda_dev)
    k = forest_eval_cuda.evaluate_forest_cuda
    with pytest.raises(ValueError):
        k(depth, flat)                                  # forest on the CPU
    with pytest.raises(ValueError):
        k(depth.to(torch.int16), flat.to(cuda_dev))
    with pytest.raises(ValueError):
        k(depth, flat.to(cuda_dev), labels_reduce=2,
          filter_images=torch.zeros((1, 8, 8), dtype=torch.int64,
                                    device=cuda_dev))
