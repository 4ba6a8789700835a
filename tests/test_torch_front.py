"""The port's front-end and back-end ops against the JAX package on the same
seeded inputs: connected components + hand groups (exact), mean shift
(atol 1e-3 px, same NaN pattern), RANSAC plane calibration from injected
uniforms (the same winning candidate, matrix rtol 1e-5), and the point ops
(exact)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fixtures

from beats3d_tpu.ops import components as jcomp
from beats3d_tpu.ops import meanshift as jms
from beats3d_tpu.ops import plane as jplane
from beats3d_tpu.ops import points as jpoints
from beats3d_tpu_torch.ops import (components, meanshift, meanshift_cuda,
                                   plane, points)


def _serpentine(h=30, w=53):
    d = np.zeros((h, w), np.uint16)
    for r in range(0, h, 2):
        d[r, :] = 1
        if r + 1 < h:
            d[r + 1, -1 if (r // 2) % 2 == 0 else 0] = 1
    return d


def _groups_scene(rng, kind):
    if kind == "blobs":
        return fixtures.blob_scene(), 0.01
    if kind == "noise":
        return (rng.random((60, 106)) < 0.45).astype(np.uint16) * 1000, 0.02
    if kind == "small_blob":
        return fixtures.blob_scene(blobs=((10, 20, 2), (40, 80, 12))), 0.01
    if kind == "two_hands":
        return fixtures.blob_scene(blobs=((30, 25, 9), (30, 80, 9))), 0.01
    return _serpentine(), 0.001


@pytest.mark.parametrize(
    "kind", ["blobs", "noise", "small_blob", "two_hands", "serpentine"])
def test_hand_groups_match_jax(rng, kind):
    d, pct = _groups_scene(rng, kind)
    want_g, want_i = jcomp.make_hand_groups(jnp.asarray(d), jnp.float32(pct))
    got_g, got_i = components.make_hand_groups(torch.as_tensor(d), pct)
    assert got_g.dtype == torch.uint16
    np.testing.assert_array_equal(got_g.numpy(), np.asarray(want_g))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))


def test_components_serpentine_single_label():
    d = _serpentine()
    want = np.asarray(jcomp.label_components(jnp.asarray(d > 0)))
    got = components.label_components(torch.as_tensor(d > 0)).numpy()
    np.testing.assert_array_equal(got[d > 0], want[d > 0])
    assert len(np.unique(got[d > 0])) == 1


def test_hand_groups_batched_equals_single(rng):
    scenes = [_groups_scene(rng, k)[0] for k in ("blobs", "noise", "two_hands")]
    g_b, i_b = components.make_hand_groups(torch.as_tensor(np.stack(scenes)),
                                           0.01)
    for k, d in enumerate(scenes):
        g, i = components.make_hand_groups(torch.as_tensor(d), 0.01)
        assert torch.equal(g_b[k], g) and torch.equal(i_b[k], i)


def _cluster_labels(rng, h=60, w=80, num_classes=3):
    labels = np.zeros((h, w), np.uint16)
    for c, (cy, cx) in enumerate([(15, 20), (40, 55), (20, 60)], start=1):
        for _ in range(150):
            y = int(np.clip(rng.normal(cy, 4), 0, h - 1))
            x = int(np.clip(rng.normal(cx, 4), 0, w - 1))
            labels[y, x] = c
    labels[0, :5] = 65535
    return labels


@pytest.mark.parametrize("num_classes,var", [(3, 8.0), (4, 8.0), (3, 0.05)])
def test_mean_shift_matches_jax(rng, num_classes, var):
    """Includes an absent class (NaN) and a bandwidth so narrow that the
    denominator underflows and the mode holds its position."""
    labels = _cluster_labels(rng)
    v = np.full(num_classes, var, np.float32)
    want = np.asarray(jms.mean_shift(jnp.asarray(labels), jnp.asarray(v),
                                     num_classes=num_classes, num_rounds=6))
    got = meanshift.mean_shift(torch.as_tensor(labels), torch.as_tensor(v),
                               num_classes=num_classes, num_rounds=6).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


@pytest.mark.parametrize("num_classes,var,rounds", [
    (3, 8.0, 6), (4, 8.0, 6), (3, 0.05, 6), (4, 8.0, 1)])
def test_mean_shift_wrapper_on_cpu_is_plain(rng, num_classes, var, rounds):
    """meanshift_cuda.mean_shift_cuda on CPU tensors is the plain version,
    bit for bit, on one image and a (2, 2) stack; it counts no launch."""
    labels = torch.as_tensor(_cluster_labels(rng).astype(np.int32))
    stack = torch.stack([labels, labels.flip(-1)])[:, None].repeat(1, 2, 1, 1)
    v = torch.full((num_classes,), var)
    before = meanshift_cuda.mean_shift_cuda.launches
    for lab in (labels, stack):
        got = meanshift_cuda.mean_shift_cuda(lab, v, num_classes=num_classes,
                                             num_rounds=rounds)
        want = meanshift.mean_shift(lab, v, num_classes=num_classes,
                                    num_rounds=rounds)
        assert got.shape == lab.shape[:-2] + (num_classes, 2)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert meanshift_cuda.mean_shift_cuda.launches == before


def _table_points(h=48, w=64):
    xx, yy = np.meshgrid(np.arange(w, dtype=np.float32),
                         np.arange(h, dtype=np.float32))
    n = np.array([0.05, -0.1, 1.0])
    n /= np.linalg.norm(n)
    z = (2000.0 - n[0] * xx * 10 - n[1] * yy * 10) / n[2]
    pts = np.stack([xx * 10, yy * 10, z, np.ones_like(z)], axis=-1)
    blob = (xx - 30) ** 2 + (yy - 20) ** 2 < 36
    pts[blob, 2] -= 300.0
    pts[0:3, 0:5] = 0.0
    return pts.astype(np.float32)


@pytest.mark.parametrize("seed,n,seeded", [(0, 2000, False), (3, 64, True)])
def test_calibrate_plane_with_injected_uniforms(seed, n, seeded):
    pts = _table_points()
    key = jax.random.PRNGKey(seed)
    start = None
    if seeded:
        start = np.array(jplane.calibrate_plane(
            jax.random.PRNGKey(1), jnp.asarray(pts), 4.0, num_candidates=512))
    u = np.array(jax.random.uniform(key, (n, 32), dtype=jnp.float32))
    j_cand = jplane.make_plane_candidates(key, jnp.asarray(pts), n)
    if seeded:
        j_cand = j_cand.at[0].set(jnp.asarray(start))
    j_counts = np.asarray(jplane.count_inliers(jnp.asarray(pts), j_cand, 4.0))
    t_cand = plane.make_plane_candidates(torch.as_tensor(u),
                                         torch.as_tensor(pts))
    if seeded:
        t_cand[0] = torch.as_tensor(start)
    t_counts = plane.count_inliers(torch.as_tensor(pts), t_cand, 4.0).numpy()
    assert int(np.argmax(t_counts)) == int(np.argmax(j_counts))

    want = np.asarray(jplane.calibrate_plane(
        key, jnp.asarray(pts), 4.0, num_candidates=n,
        start_mat=None if start is None else jnp.asarray(start)))
    got = plane.calibrate_plane(
        torch.as_tensor(u), torch.as_tensor(pts), 4.0,
        start_mat=None if start is None else torch.as_tensor(start)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_calibrated_plane_recovers_table():
    pts = _table_points()
    cp = plane.CalibratedPlane(2000, 4.0, seed=0, device="cpu")
    mat = cp.make(torch.as_tensor(pts)).numpy()
    flat = pts.reshape(-1, 4)
    q = (mat @ flat.T).T
    on_plane = (flat[:, 3] == 1) & (np.abs(q[:, 2]) < 4.0)
    assert on_plane.sum() / (flat[:, 3] == 1).sum() > 0.9
    np.testing.assert_allclose(mat[:3, :3] @ mat[:3, :3].T, np.eye(3),
                               atol=1e-4)


def test_point_ops_match_jax(rng):
    d = fixtures.random_depth_image(rng, 2, 24, 40)
    pp = np.array([19.5, 11.0], np.float32)
    dt = torch.as_tensor(d)
    np.testing.assert_array_equal(
        points.deproject_points(dt, pp, 31.0).numpy(),
        np.asarray(jpoints.deproject_points(jnp.asarray(d), jnp.asarray(pp),
                                            31.0)))
    for name, args in (("shrink_image", (3,)), ("flip_x", ()),
                       ("convert_0s_to_maxuint", ())):
        np.testing.assert_array_equal(
            getattr(points, name)(dt, *args).numpy(),
            np.asarray(getattr(jpoints, name)(jnp.asarray(d), *args)))

    g = (rng.random((2, 6, 8)) < 0.2).astype(np.uint16) * rng.integers(
        1, 3, (2, 6, 8)).astype(np.uint16)
    np.testing.assert_array_equal(
        points.grow_groups(torch.as_tensor(g)).numpy(),
        np.asarray(jpoints.grow_groups(jnp.asarray(g))))
    for gid in (1, 2):
        np.testing.assert_array_equal(
            points.stencil_depth_image_by_group(
                torch.as_tensor(g[0]), torch.as_tensor(d[0, :24, :32]), 2,
                gid).numpy(),
            np.asarray(jpoints.stencil_depth_image_by_group(
                jnp.asarray(g[0]), jnp.asarray(d[0, :24, :32]), 2, gid)))

    labels = rng.integers(0, 7, (10, 12)).astype(np.uint16)
    labels[0, :3] = 65535
    colors = rng.integers(0, 256, (6, 4)).astype(np.uint8)
    np.testing.assert_array_equal(
        points.make_rgba_from_labels(torch.as_tensor(labels), colors).numpy(),
        np.asarray(jpoints.make_rgba_from_labels(jnp.asarray(labels),
                                                 jnp.asarray(colors))))


@pytest.mark.parametrize(
    "kind", ["blobs", "noise", "small_blob", "two_hands", "serpentine"])
def test_label_components_match_jax(rng, kind):
    """The union-find kernel's plain version (the CPU path) against JAX's
    while_loop, every pixel, background (H*W) included."""
    d, _ = _groups_scene(rng, kind)
    want = np.asarray(jcomp.label_components(jnp.asarray(d > 0)))
    got = components.label_components(torch.as_tensor(d > 0))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        components.label_components_plain(torch.as_tensor(d > 0)).numpy(),
        want)


def test_crop_and_place_match_jax(rng):
    """crop / place at device-side origins against crop_mm / scatter_mm, at
    random origins and at the edges (flush with each side, and windows
    that hang over them), exactly."""
    img = rng.integers(0, 65536, (40, 56)).astype(np.uint16)
    ch, cw, hh, ww = 16, 24, 40, 56
    origins = [(0, 0), (hh - ch, ww - cw), (0, ww - cw), (hh - ch, 0),
               (-5, -7), (hh - 3, ww - 2)]
    origins += [tuple(o) for o in rng.integers(0, [hh - ch, ww - cw],
                                               (6, 2))]
    oy = torch.tensor([o[0] for o in origins])
    ox = torch.tensor([o[1] for o in origins])
    stack = torch.as_tensor(np.repeat(img[None].astype(np.int32),
                                      len(origins), 0))
    crops = points.crop(stack, oy, ox, ch, cw)
    tile = rng.integers(0, 65536, (len(origins), ch, cw)).astype(np.uint16)
    placed = points.place(65535, torch.as_tensor(tile.astype(np.int32)), oy,
                          ox, hh, ww)
    for i, (y, x) in enumerate(origins):
        np.testing.assert_array_equal(
            crops[i].numpy(), np.asarray(jpoints.crop_mm(
                jnp.asarray(img), y, x, ch, cw)), err_msg=f"crop at {y, x}")
        np.testing.assert_array_equal(
            placed[i].numpy(), np.asarray(jpoints.scatter_mm(
                jnp.asarray(65535, jnp.uint16), jnp.asarray(tile[i]), y, x,
                hh, ww)), err_msg=f"place at {y, x}")


@pytest.mark.parametrize("num_coords", [0, 2, 3, 6])
def test_write_pixel_groups_matches_jax(num_coords):
    """tests/test_points.py's scatter rows, then rows that meet, a negative
    coordinate (counted from the end) and rows outside the image
    (dropped)."""
    coords = np.array([[1, 2, 1], [3, 4, 2], [0, 0, 9], [1, 2, 3],
                       [-1, -2, 4], [7, 0, 5]], np.int32)
    want = np.asarray(jpoints.write_pixel_groups_to_stencil_image(
        jnp.asarray(coords), num_coords, (5, 6)))
    got = points.write_pixel_groups_to_stencil_image(coords, num_coords, (5, 6))
    assert got.dtype == torch.uint16
    np.testing.assert_array_equal(got.numpy(), want)


def test_make_depth_rgba_matches_jax(rng):
    """tests/test_points.py's sentinel cases, then every grey level of the
    range and its ends (256 saturates to 255)."""
    d = np.array([[0, 100], [65535, 300]], np.uint16)
    extra = np.concatenate([np.arange(40, 261), rng.integers(0, 65536, 59)])
    for depth in (d, extra.astype(np.uint16).reshape(28, 10)):
        want = np.asarray(jpoints.make_depth_rgba(jnp.asarray(depth), 50, 250))
        got = points.make_depth_rgba(torch.as_tensor(depth.astype(np.int32)),
                                     50, 250)
        np.testing.assert_array_equal(got.numpy(), want)
