"""The port's point ops and splat renderer (beats3d_tpu_torch.ops.points,
.render) against the JAX package on the CPU, bit for bit: transforms of
coordinates up to 65535 (C-w11: XLA sums the 4-term row pairwise, each
product rounded), depth casts out of range, projection, the z-buffer with
exact z ties, the hole fill; and the render-and-compare cost (exact where
the JAX sum is, else rtol 1e-6)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beats3d_tpu.ops import points as jpoints
from beats3d_tpu.ops import render as jrender
from beats3d_tpu.utils import CameraIntrinsics
from beats3d_tpu_torch.ops import points, render


def _big_cloud(rng, h, w, valid_share=0.9):
    """Points up to +-65535 in x and y, z drawn from values that straddle
    the uint16 range and its integer steps, w == 1 on ``valid_share``."""
    pts = np.zeros((h, w, 4), np.float32)
    pts[..., 0] = rng.uniform(-65535, 65535, (h, w))
    pts[..., 1] = rng.uniform(-65535, 65535, (h, w))
    pts[..., 2] = rng.choice(
        np.array([1000.0, 1000.5, 999.99994, 65534.5, 65535.0, 70000.0,
                  -3.0, 0.0, 2.5e9], np.float32), (h, w))
    pts[..., 3] = rng.random((h, w)) < valid_share
    return pts


def _matrix(rng):
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] += rng.normal(0, 0.1, (3, 3)).astype(np.float32)
    m[:3, 3] = rng.uniform(-3000, 3000, 3).astype(np.float32)
    return m


@pytest.mark.parametrize("shape", [(60, 106), (7, 3), (480, 848)])
def test_transform_points_matches_jax(rng, shape):
    pts = _big_cloud(rng, *shape)
    pts[..., 2] = rng.uniform(0, 65535, shape)
    m = _matrix(rng)
    want = np.asarray(jpoints.transform_points(jnp.asarray(pts),
                                               jnp.asarray(m)))
    got = points.transform_points(torch.as_tensor(pts), m).numpy()
    np.testing.assert_array_equal(got, want)


def test_point_image_ops_match_jax(rng):
    pts = _big_cloud(rng, 24, 40, valid_share=0.7)
    pts[0, :4, 2] = [np.nan, np.inf, -np.inf, 65535.9]
    pts[1, :3, 3] = [0.5, 2.0, -1.0]
    depth = rng.integers(0, 4000, (24, 40)).astype(np.uint16)
    depth[rng.random((24, 40)) < 0.2] = 0
    jp, tp = jnp.asarray(pts), torch.as_tensor(pts)
    got = points.depths_from_points(tp)
    assert got.dtype == torch.uint16
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jpoints.depths_from_points(jp)))
    for name in ("remove_missing_3d_points_from_depth_image",
                 "setup_depth_image_for_forest"):
        np.testing.assert_array_equal(
            getattr(points, name)(tp, torch.as_tensor(depth)).numpy(),
            np.asarray(getattr(jpoints, name)(jp, jnp.asarray(depth))))
    for thr in (40.0, 0.3):
        np.testing.assert_array_equal(
            points.filter_points_by_plane(tp, thr).numpy(),
            np.asarray(jpoints.filter_points_by_plane(jp, jnp.float32(thr))))


def test_project_points_matches_jax(rng):
    intrin = CameraIntrinsics.d415(106, 60)
    pts = _big_cloud(rng, 60, 106)
    pts[0, :3, 2] = [1e-30, 1e-3, -0.0]        # projections past int32
    want = jrender.project_points(jnp.asarray(pts), jnp.asarray(intrin.pp),
                                  jnp.float32(intrin.fx))
    got = render.project_points(torch.as_tensor(pts), intrin.pp, intrin.fx)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _splat_both(pts, colors, intrin):
    want = jrender.splat_points(jnp.asarray(pts), jnp.asarray(colors),
                                jnp.asarray(intrin.pp), jnp.float32(intrin.fx))
    got = render.splat_points(torch.as_tensor(pts), torch.as_tensor(colors),
                              intrin.pp, intrin.fx)
    assert got[0].dtype == torch.uint16 and got[1].dtype == torch.uint8
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    return got


@pytest.mark.parametrize("kind", ["reprojected", "big", "ties"])
def test_splat_and_fill_match_jax(rng, kind):
    intrin = CameraIntrinsics.d415(106, 60)
    h, w = 60, 106
    colors = rng.integers(1, 255, (h, w, 3)).astype(np.uint8)
    if kind == "reprojected":
        # a depth frame deprojected, moved and rendered again, as datagen
        # re-renders its augmented frames
        depth = rng.integers(500, 3000, (h, w)).astype(np.uint16)
        depth[10:14, 10:14] = 0
        move = np.array([[1.05, 0.02, 0, 20], [-0.01, 0.97, 0, -15],
                         [0.001, 0, 1.01, 80], [0, 0, 0, 1]], np.float32)
        pts = points.transform_points(points.deproject_points(
            torch.as_tensor(depth), intrin.pp, intrin.fx), move).numpy()
    elif kind == "big":
        pts = _big_cloud(rng, h, w)
    else:
        # many sources on a few pixels at a few depths: exact z ties go to
        # the lowest source index
        pts = np.zeros((h, w, 4), np.float32)
        pts[..., 0] = rng.integers(-3, 3, (h, w)) * 40.0
        pts[..., 1] = rng.integers(-2, 2, (h, w)) * 40.0
        pts[..., 2] = rng.choice(np.array([1000.0, 1000.25, 1001.0, 999.5],
                                          np.float32), (h, w))
        pts[..., 3] = 1.0
    d, c = _splat_both(pts, colors, intrin)
    assert int((d.numpy() > 0).sum()) > 0
    want = jrender.fill_holes(jnp.asarray(d.numpy()), jnp.asarray(c.numpy()))
    got = render.fill_holes(d, c)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_splat_z_order():
    """Two points on the same pixel: the nearer wins, with its colour."""
    intrin = CameraIntrinsics.d415(16, 16)
    pts = np.zeros((16, 16, 4), np.float32)
    pts[0, 0] = [0, 0, 1000, 1]
    pts[1, 1] = [0, 0, 900, 1]
    colors = np.zeros((16, 16, 3), np.uint8)
    colors[0, 0] = (10, 10, 10)
    colors[1, 1] = (20, 20, 20)
    d, c = _splat_both(pts, colors, intrin)
    cx, cy = int(intrin.ppx), int(intrin.ppy)
    assert int(d[cy, cx]) == 900 and int(c[cy, cx, 0]) == 20


def test_calc_image_cost_matches_jax(rng):
    d0 = np.array([[0, 100], [100, 100]], np.uint16)
    labels = np.array([[1, 1], [0, 1]], np.uint16)
    for d1, want in ((np.array([[50, 0], [80, 0]], np.uint16), 300.0),
                     (np.array([[50, 90], [0, 110]], np.uint16), None)):
        got = float(render.calc_image_cost(
            torch.as_tensor(d0), torch.as_tensor(d1), torch.as_tensor(labels),
            1))
        ref = float(jrender.calc_image_cost(d0, d1, labels, 1))
        assert got == ref and (want is None or got == want)

    d0 = rng.integers(500, 3000, (60, 106)).astype(np.uint16)
    d0[rng.random(d0.shape) < 0.1] = 0
    d1 = (d0.astype(np.int64) + rng.integers(-40, 40, d0.shape)).clip(0)
    d1 = d1.astype(np.uint16)
    d1[rng.random(d0.shape) < 0.2] = 0
    labels = (rng.random(d0.shape) < 0.6).astype(np.uint16)
    got = render.calc_image_cost(torch.as_tensor(d0), torch.as_tensor(d1),
                                 torch.as_tensor(labels), 1)
    assert got.dtype == torch.float32
    want = float(jrender.calc_image_cost(d0, d1, labels, 1))
    np.testing.assert_allclose(float(got), want, rtol=1e-6)
