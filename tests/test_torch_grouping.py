"""The frame's grouping stage (``components.hand_groups_grown``) on the CPU
against the JAX package's ``shrink_image`` -> ``make_hand_groups`` ->
``grow_groups`` on the same numpy inputs: groups_small, grown and the bits
of g_info exact, one image and a batch, on the selection's traps and the
labelling's hard shapes.  Then a host model of the grouping kernel's
labelling passes (csrc/components.cu: run-based init, the merge's unions,
compress), its unions run in shuffled orders and interleaved step by step,
against ``label_components_plain``: the kernel's answer does not depend on
the order of its threads."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fixtures

from beats3d_tpu.ops import components as jcomp
from beats3d_tpu.ops import points as jpoints
from beats3d_tpu_torch import kernel_bench
from beats3d_tpu_torch.data.synth import articulated_scene, part_labels
from beats3d_tpu_torch.ops import components, cuda_lib
from beats3d_tpu_torch.utils import CameraIntrinsics


def _serpentine(h=30, w=53):
    m = np.zeros((h, w), bool)
    for r in range(0, h, 2):
        m[r, :] = True
        if r + 1 < h:
            m[r + 1, -1 if (r // 2) % 2 == 0 else 0] = True
    return m


def _case(name, rng):
    """(depth (H, W) int32, mipmap level, pct_thresh) of a named case."""
    if name == "empty_side_slot0":
        # a small component rooted at pixel 0 (centroid 1/3, 1/3) under the
        # threshold and one right-hand survivor: the left row is slot 0's
        d = np.zeros((8, 10), np.int32)
        d[0, 0:2] = d[1, 0] = 1
        d[3:7, 6:10] = 1
        return d, 0, 0.1
    if name == "empty_side_no_pixel0":
        d = np.zeros((8, 10), np.int32)
        d[3:7, 6:10] = 1
        return d, 0, 0.1
    if name == "background_clamp":
        # pixel n - 1 is a component of its own among background pixels,
        # all of which clamp to its slot with weight 0
        d = np.zeros((9, 11), np.int32)
        d[-1, -1] = 5
        d[2:4, 1:3] = 5
        return d, 0, 0.0
    if name == "equal_scores":
        d = np.zeros((8, 8), np.int32)
        d[1:3, 1:3] = d[5:7, 1:3] = 1            # two right-hand 2x2s
        d[1:3, 5:7] = d[5:7, 5:7] = 1            # two left-hand 2x2s
        return d, 0, 0.0
    if name == "size_equals_pct":
        # 8 / 64 == 0.125 exactly: not a survivor; 9 / 64 is
        d = np.zeros((8, 8), np.int32)
        d[0:2, 0:4] = 1
        d[5:8, 5:8] = 1
        return d, 0, 0.125
    if name == "checkerboard":
        return (np.indices((20, 37)).sum(0) % 2).astype(np.int32) * 9, 0, 0.0
    if name == "serpentine":
        return _serpentine().astype(np.int32) * 3, 0, 0.001
    if name == "empty":
        return np.zeros((12, 20), np.int32), 0, 0.01
    if name == "all_on":
        return np.full((12, 20), 7, np.int32), 0, 0.01
    if name == "one_row":
        return (rng.random((1, 140)) < 0.6).astype(np.int32), 0, 0.0
    if name == "one_column":
        return (rng.random((140, 1)) < 0.6).astype(np.int32), 0, 0.0
    if name == "blobs_level3":
        return fixtures.blob_scene(h=240, w=424, blobs=(
            (120, 100, 70), (120, 320, 60))).astype(np.int32), 3, 0.06
    # noise at the pipeline's mipmap level, odd sides (the shrink's ragged
    # edge)
    return ((rng.random((123, 213)) < 0.5) * rng.integers(
        1, 3000, (123, 213))).astype(np.int32), 3, 0.02


CASES = ["empty_side_slot0", "empty_side_no_pixel0", "background_clamp",
         "equal_scores", "size_equals_pct", "checkerboard", "serpentine",
         "empty", "all_on", "one_row", "one_column", "blobs_level3",
         "noise_level3"]


def _jax_stage(depth, level, pct):
    small = jpoints.shrink_image(jnp.asarray(depth.astype(np.uint16)), level)
    g, info = jcomp.make_hand_groups(small, jnp.float32(pct))
    return (np.asarray(jpoints.grow_groups(g)), np.asarray(info),
            np.asarray(g))


def _assert_stage(got, want):
    grown, info, groups = got
    assert grown.dtype == groups.dtype == torch.int32
    np.testing.assert_array_equal(groups.numpy(), want[2])
    np.testing.assert_array_equal(grown.numpy(), want[0])
    np.testing.assert_array_equal(info.numpy().view(np.int32),
                                  want[1].view(np.int32))


@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("name", CASES)
def test_stage_matches_jax(rng, name, batch):
    """The stage entry on one image and on a batch (the case, its mirror
    and its upside-down copy) equals JAX's composition exactly."""
    depth, level, pct = _case(name, rng)
    if batch == 1:
        _assert_stage(components.hand_groups_grown(torch.as_tensor(depth),
                                                   level, pct),
                      _jax_stage(depth, level, pct))
        return
    stack = np.stack([depth, depth[:, ::-1], depth[::-1]])
    got = components.hand_groups_grown(torch.as_tensor(stack), level,
                                       torch.tensor(pct, dtype=torch.float32))
    assert got[1].shape == (3, 2, 3)
    for k in range(3):
        _assert_stage([t[k] for t in got], _jax_stage(stack[k], level, pct))


def _past_one_block(name):
    """(depth (H, W) int32, level, pct) of an image whose mipmap holds more
    than BLOCK_PIXELS pixels (the card's multi-block path): a 480x848
    two-hand scene at level 1 (240x424), or a 240x424 serpentine."""
    if name == "two_hands_level1":
        intrin = CameraIntrinsics.d415()
        d, c = articulated_scene(intrin, np.random.default_rng(1000),
                                 two_hands=True, flex_scale=0.3)
        return np.where(part_labels(c) > 0, d, 0).astype(np.int32), 1, 0.06
    return kernel_bench.serpentine(240, 424).astype(np.int32) * 3, 0, 0.001


@pytest.mark.parametrize("name", ["two_hands_level1", "serpentine_240x424"])
def test_stage_past_one_block_matches_jax(name):
    """make_hand_groups and the stage on mipmaps of 240x424 (more than
    BLOCK_PIXELS) against JAX's make_hand_groups and its composition.  Their
    sums stay below 2**24 (ROADMAP C-w15), so every output is exact."""
    depth, level, pct = _past_one_block(name)
    small = depth[::1 << level, ::1 << level]
    assert small.size > components.BLOCK_PIXELS
    want = _jax_stage(depth, level, pct)
    _assert_stage(components.hand_groups_grown(torch.as_tensor(depth), level,
                                               pct), want)
    groups, info = components.make_hand_groups(torch.as_tensor(small), pct)
    np.testing.assert_array_equal(groups.numpy(), want[2])
    np.testing.assert_array_equal(info.numpy().view(np.int32),
                                  want[1].view(np.int32))
    assert (want[1][:, 0] > 0).any()
    _, biggest = kernel_bench.exact_centroids(
        torch.as_tensor(small)[None], groups[None])
    assert biggest < 2 ** 24


def test_stage_traps_values(rng):
    """The selection's traps, by value: an empty side reports slot 0's
    centroid, the clamped background leaves slot n - 1's size alone, equal
    sizes go to the smaller root, and size / n == pct does not survive."""
    def info(name):
        d, level, pct = _case(name, rng)
        return components.hand_groups_grown(torch.as_tensor(d), level,
                                            pct)[1].numpy()

    third = np.float32(1) / np.float32(3)
    np.testing.assert_array_equal(info("empty_side_slot0"),
                                  [[0, third, third], [16, 7.5, 4.5]])
    np.testing.assert_array_equal(info("empty_side_no_pixel0"),
                                  [[0, 0, 0], [16, 7.5, 4.5]])
    np.testing.assert_array_equal(info("background_clamp"),
                                  [[4, 1.5, 2.5], [1, 10, 8]])
    d, _, _ = _case("equal_scores", rng)
    grown, g_info, groups = components.hand_groups_grown(
        torch.as_tensor(d), 0, 0.0)
    np.testing.assert_array_equal(g_info.numpy(),
                                  [[4, 1.5, 1.5], [4, 5.5, 1.5]])
    assert groups[1:3, 1:3].eq(1).all() and groups[5:7, 1:3].eq(0).all()
    np.testing.assert_array_equal(info("size_equals_pct"),
                                  [[0, 1.5, 0.5], [9, 6, 6]])


def test_stage_cpu_never_reaches_the_kernel(rng, monkeypatch):
    """A CPU tensor takes the plain composition in all three entries: the
    kernel library is never loaded, and no launch is counted."""
    def no_library():
        raise AssertionError("the kernel library was loaded for a CPU tensor")

    monkeypatch.setattr(cuda_lib, "library", no_library)
    counts = [f.launches for f in (components.hand_groups_grown,
                                   components.make_hand_groups,
                                   components.label_components)]
    d, level, pct = _case("noise_level3", rng)
    t = torch.as_tensor(d)
    components.hand_groups_grown(t, level, pct)
    components.make_hand_groups(t, pct)
    components.label_components(t > 0)
    assert counts == [f.launches for f in (components.hand_groups_grown,
                                           components.make_hand_groups,
                                           components.label_components)]


def test_kernel_source_has_no_fixpoint_loop():
    """The grouping kernel runs a fixed number of block-wide passes: no
    block-wide vote decides whether to run another round."""
    with open(os.path.join(cuda_lib.CSRC_DIR, "components.cu")) as f:
        src = f.read()
    assert "__syncthreads_or" not in src and "__syncthreads_count" not in src


# ---------------------------------------------- a host model of the kernel

SEG = 32   # pixels of one row a warp takes


def _find(lab, a):
    """find_root: one step per read of the shared labels and per
    compare-and-swap; each step points a node at its grandparent (while
    its parent is unchanged) and moves there."""
    while True:
        p = lab[a]
        yield
        if p == a:
            return a
        g = lab[p]
        yield
        if g == p:
            return p
        if lab[a] == p:
            lab[a] = g
        yield
        a = g


def _unite(lab, a, b):
    """unite: both roots, then a compare-and-swap that hooks the larger
    under the smaller only while it is a root (one step), retried from the
    parent it returned."""
    a = yield from _find(lab, a)
    b = yield from _find(lab, b)
    while a != b:
        a, b = max(a, b), min(a, b)
        old = lab[a]
        if old == a:
            lab[a] = b
        yield
        if old == a:
            return
        a = yield from _find(lab, old)
        b = yield from _find(lab, b)


def _model_labels(mask, order_rng, interleave):
    """The kernel's passes 1-3 on one (h, w) mask: run-based init per
    32-pixel row segment, the merge's unions (each pixel's thread: the
    segment-boundary union, then the one with the pixel above unless the
    left and up-left pixels join them), then compress (each run takes its
    first pixel's root).  The threads' unions run in a shuffled order, each
    to its end, or interleaved one shared read or atomic at a time in a
    random schedule."""
    h, w = mask.shape
    n = h * w
    lab = np.full(n, n, np.int64)
    for y in range(h):
        for x in range(w):
            if mask[y, x]:
                x0 = x - x % SEG
                s = x
                while s > x0 and mask[y, s - 1]:
                    s -= 1
                lab[y * w + x] = y * w + s
    threads = []
    for y in range(h):
        for x in range(w):
            if not mask[y, x]:
                continue
            i = y * w + x
            left = x > 0 and mask[y, x - 1]
            pairs = []
            if x % SEG == 0 and left:
                pairs.append((i, i - 1))
            if y > 0 and mask[y - 1, x] and not (left and mask[y - 1, x - 1]):
                pairs.append((i, i - w))
            if pairs:
                threads.append(pairs)

    def thread(pairs):
        for a, b in pairs:
            yield from _unite(lab, a, b)

    gens = [thread(p) for p in threads]
    order_rng.shuffle(gens)
    if interleave:
        while gens:
            k = int(order_rng.integers(len(gens)))
            try:
                next(gens[k])
            except StopIteration:
                gens[k] = gens[-1]
                gens.pop()
    else:
        for g in gens:
            for _ in g:
                pass
    out = lab.copy()
    for i in np.flatnonzero(lab < n):
        r = i
        while lab[r] != r:
            r = lab[r]
        out[i] = r
    return out.reshape(h, w)


def _model_masks(rng):
    return {
        "noise_sparse": rng.random((14, 75)) < 0.4,
        "noise_dense": rng.random((14, 75)) < 0.62,
        "serpentine": _serpentine(15, 70),
        "checkerboard": np.indices((9, 66)).sum(0) % 2 == 1,
        "all_on": np.ones((6, 97), bool),
        "comb": np.indices((12, 70))[1] % 3 != 1,
    }


@pytest.mark.parametrize("interleave", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_union_find_model_is_order_free(rng, seed, interleave):
    """The host model of the merge equals ``label_components_plain`` (the
    minimum index of each component) in every order of its unions."""
    for name, mask in _model_masks(rng).items():
        want = components.label_components_plain(torch.as_tensor(mask))
        got = _model_labels(mask, np.random.default_rng(seed), interleave)
        np.testing.assert_array_equal(got, want.numpy(), err_msg=name)
