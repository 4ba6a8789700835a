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
from beats3d_tpu_torch.ops import forest_eval_cuda, points, preproc_cuda

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
