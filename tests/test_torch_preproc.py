"""The port's plane-band + missing-aware gaussian (the plain version of
kernel K2: points.plane_band_depth -> points.gaussian_depth_filter) against
the JAX package's XLA chain and its Pallas kernel in interpret mode, on the
scenes of test_preproc_pallas.py.

Tolerance: missing masks exact, |d| <= 1.  The port sums the 25 taps in
row-major order, XLA as a convolution and the Pallas kernel separably, so
floor(sn / wn) may move by one depth unit where the weighted mean sits on an
integer."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fixtures

from beats3d_tpu.ops import points as jpoints
from beats3d_tpu.ops.preproc_pallas import plane_band_gauss
from beats3d_tpu_torch.ops import points, preproc_cuda

PLANE = np.array(
    [[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, -2600.0], [0, 0, 0, 1]], np.float32)


def _jax_chain(d, pp, focal, thr):
    k = jnp.asarray(jpoints.gaussian_kernel(5, 2.0))
    mat = jnp.asarray(PLANE)
    return np.stack([
        np.asarray(jpoints.gaussian_depth_filter(
            jpoints.plane_band_depth(jnp.asarray(img), mat, jnp.asarray(pp),
                                     focal, thr), k))
        for img in d.reshape((-1,) + d.shape[-2:])
    ]).reshape(d.shape)


def _port(d, pp, focal, thr):
    out = preproc_cuda.plane_band_gauss_cuda(
        torch.as_tensor(d), torch.as_tensor(PLANE), pp, focal, thr)
    assert out.dtype == torch.uint16
    return out.numpy()


def _compare(got, want):
    got = got.astype(np.int32)
    want = np.asarray(want).astype(np.int32)
    np.testing.assert_array_equal(got == 0, want == 0)
    assert np.abs(got - want).max() <= 1


def _scene(rng, kind):
    if kind == "random":
        d = fixtures.random_depth_image(
            rng, 1, 48, 144, missing_frac=0.3, far_frac=0.0)[0]
        return np.where(d > 0, (d % 500) + 2300, 0).astype(np.uint16), \
            np.array([31.0, 17.0], np.float32), 200.0
    if kind == "batched_borders":
        d = fixtures.random_depth_image(
            rng, 3, 40, 128, missing_frac=0.15, far_frac=0.0)
        d = np.where(d > 0, (d % 400) + 2350, 0).astype(np.uint16)
        d[:, 8:16, :] = 2500
        return d, np.array([64.0, 24.0], np.float32), 180.0
    d = np.full((32, 128), 2500, np.uint16)
    d[:16, :] = 2599  # within 40 units of the plane -> filtered
    return d, np.array([16.0, 16.0], np.float32), 150.0


@pytest.mark.parametrize("kind", ["random", "batched_borders", "band"])
def test_matches_jax_xla_chain(rng, kind):
    d, pp, focal = _scene(rng, kind)
    got = _port(d, pp, focal, 40.0)
    _compare(got, _jax_chain(d, pp, focal, 40.0))
    assert got.any(), "degenerate scene: everything filtered"
    if kind == "band":
        assert (got[:12, :] == 0).all() and (got[20:, :] != 0).all()


@pytest.mark.parametrize("kind", ["random", "batched_borders"])
def test_matches_pallas_interpret(rng, kind):
    d, pp, focal = _scene(rng, kind)
    want = plane_band_gauss(
        jnp.asarray(d), jnp.asarray(PLANE), jnp.asarray(pp), focal, 40.0,
        ksize=5, sigma=2.0, interpret=True)
    _compare(_port(d, pp, focal, 40.0), want)


def test_plane_band_depth_is_exact(rng):
    d, pp, focal = _scene(rng, "random")
    mat = PLANE.copy()
    mat[2, :3] = [0.03, -0.05, 0.998]
    want = np.asarray(jpoints.plane_band_depth(
        jnp.asarray(d), jnp.asarray(mat), jnp.asarray(pp), focal, 40.0))
    got = points.plane_band_depth(torch.as_tensor(d), torch.as_tensor(mat),
                                  pp, focal, 40.0)
    np.testing.assert_array_equal(got.numpy(), want)


def test_gaussian_kernel_and_int32_carry(rng):
    np.testing.assert_array_equal(points.gaussian_kernel(5, 2.0),
                                  jpoints.gaussian_kernel(5, 2.0))
    d, pp, focal = _scene(rng, "batched_borders")
    a = preproc_cuda.plane_band_gauss_cuda(
        torch.as_tensor(d).to(torch.int32), torch.as_tensor(PLANE), pp,
        focal, 40.0)
    assert a.dtype == torch.int32
    np.testing.assert_array_equal(a.numpy(), _port(d, pp, focal, 40.0))


def test_kernel_taps_built_once_with_row_major_sum():
    """The K2 wrapper's taps: the 25 weights of gaussian_kernel(5, 2.0) in
    row-major order and their float32 row-major sum, which is the plain
    filter's wn at a pixel whose 25 taps are all kept; built once."""
    taps = preproc_cuda.kernel_taps(5, 2.0)
    assert taps is preproc_cuda.kernel_taps(5, 2.0)
    k = points.gaussian_kernel(5, 2.0)
    np.testing.assert_array_equal(np.asarray(taps[:25], np.float32),
                                  k.reshape(-1))
    wn = torch.zeros((), dtype=torch.float32)
    for kv in torch.as_tensor(k).reshape(-1):
        wn = wn + kv
    assert np.float32(taps[25]) == np.float32(wn.item())
    # a kept 7x7 patch of one depth: the centre pixel's output is
    # floor(sn / wn) with that wn
    d = np.zeros((1, 7, 7), np.uint16)
    d[:] = 2300
    out = preproc_cuda.plane_band_gauss_cuda(
        torch.as_tensor(d), torch.as_tensor(PLANE), (3.0, 3.0), 600.0, 40.0)
    sn = torch.zeros((), dtype=torch.float32)
    for kv in torch.as_tensor(k).reshape(-1):
        sn = sn + kv * torch.tensor(2300.0)
    assert int(out[0, 3, 3]) == int(np.floor(np.float32(sn.item()) / np.float32(taps[25])))
