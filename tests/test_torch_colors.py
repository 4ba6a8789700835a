"""The port's palette ops (beats3d_tpu_torch.ops.colors) against the JAX
package on the CPU: nearest-colour indices and snapped colours bit for bit;
per-colour counts and RGB sums exact; k-means palettes bit for bit while
every colour's RGB sum stays below 2**24 (where the JAX package's float32
sums are exact, ROADMAP C-w9); costs within rtol 1e-6."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beats3d_tpu.ops import colors as jcolors
from beats3d_tpu_torch.ops import colors


def _image(rng, h=60, w=106, black=0.3, levels=None):
    if levels is None:
        img = rng.integers(0, 256, (h, w, 3))
    else:
        img = rng.choice(np.asarray(levels), (h, w, 3))
    img = img.astype(np.uint8)
    img[rng.random((h, w)) < black] = 0
    return img


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_assignment_and_snap_match_jax(seed):
    rng = np.random.default_rng(seed)
    img = _image(rng)
    pal_f = rng.uniform(0, 255, (6, 3)).astype(np.float32)
    # a palette with repeated colours: ties go to the first
    pal_u8 = np.concatenate([pal_f[:3], pal_f[:3]]).round().astype(np.uint8)
    for pal in (pal_f, pal_u8):
        np.testing.assert_array_equal(
            colors.nearest_color_idx(torch.as_tensor(img),
                                     torch.as_tensor(pal)).numpy(),
            np.asarray(jcolors._nearest_color_idx(jnp.asarray(img),
                                                  jnp.asarray(pal))))
    got = colors.apply_point_mapping(torch.as_tensor(img),
                                     torch.as_tensor(pal_u8))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jcolors.apply_point_mapping(
            jnp.asarray(img), jnp.asarray(pal_u8))))


def test_split_pixels_matches_jax(rng):
    img = _image(rng)
    pal = rng.integers(0, 256, (5, 3)).astype(np.uint8)
    got = colors.split_pixels_by_nearest_color(torch.as_tensor(img),
                                               torch.as_tensor(pal))
    want = jcolors.split_pixels_by_nearest_color(jnp.asarray(img),
                                                 jnp.asarray(pal))
    for g, w in zip(got[:2], want[:2]):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=1e-6)


def test_sums_exact_past_float32():
    """300k pixels of 255: the int64 sums stay exact where a float32 sum
    would not (2**24 < 255 * 300000)."""
    img = np.full((500, 600, 3), 255, np.uint8)
    img[:, :300] = (200, 10, 7)
    pal = np.array([[255, 255, 255], [200, 10, 7], [0, 0, 1]], np.uint8)
    counts, sums, _ = colors.split_pixels_by_nearest_color(
        torch.as_tensor(img), torch.as_tensor(pal))
    np.testing.assert_array_equal(counts.numpy(), [150000, 150000, 0])
    assert float(sums[0, 0]) == float(np.float32(255 * 150000))
    np.testing.assert_array_equal(
        colors._segment_stats(torch.as_tensor(img.reshape(-1, 3)),
                              torch.zeros(300000, dtype=torch.int64), 1)[1],
        [[255 * 150000 + 200 * 150000, 255 * 150000 + 10 * 150000,
          255 * 150000 + 7 * 150000]])


@pytest.mark.parametrize("case", ["random", "few_levels", "dead_clusters"])
def test_kmeans_matches_jax(rng, case):
    if case == "random":
        img, k = _image(rng), 6
    elif case == "few_levels":
        img, k = _image(rng, levels=[0, 40, 200, 220]), 4
    else:
        # three colours and six clusters: dead clusters are reseeded
        img = np.zeros((60, 106, 3), np.uint8)
        img[:20] = (200, 40, 40)
        img[20:35] = (40, 200, 40)
        img[35:45] = (40, 40, 200)
        k = 6
    # every colour's RGB sum stays below 2**24
    assert 255 * int((img.sum(axis=-1) > 0).sum()) < 2 ** 24
    for _ in range(3):
        init = rng.uniform(0, 255, (k, 3)).astype(np.float32)
        want_pal, want_cost = jcolors.kmeans_palette_step(
            jnp.asarray(img), jnp.asarray(init), num_iters=16)
        got_pal, got_cost = colors.kmeans_palette_step(
            torch.as_tensor(img), torch.as_tensor(init), num_iters=16)
        np.testing.assert_array_equal(got_pal.numpy(), np.asarray(want_pal))
        np.testing.assert_allclose(float(got_cost), float(want_cost),
                                   rtol=1e-6)
