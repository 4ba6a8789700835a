"""The port's training split bits (beats3d_tpu_torch.ops.train_features, the
plain version of kernel B4) against the JAX package on the same seeded
inputs: the Pallas kernel it replaces in interpret mode and the JAX
trainer's feature evaluator.  Bits must be exact.

The CUDA kernel itself is checked on the card by tests/test_torch_cuda.py
and chip_smoke.py; on the CPU its wrapper runs the plain version tested
here."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fixtures

from beats3d_tpu.ops.train_features_pallas import train_feature_bits
from beats3d_tpu.train.trainer import _chunk_features
from beats3d_tpu_torch import kernel_bench
from beats3d_tpu_torch.ops import train_features, train_features_cuda
from beats3d_tpu_torch.train.proposals import make_random_features

P = 40  # not a multiple of 32: the second word is partly used


def _inputs(rng):
    depth, labels = fixtures.synthetic_hand_dataset(rng, n=2, h=24, w=40)
    depth[0, 3, 5] = 0          # zero centre: f = 0
    depth[1, 0, 0] = 65535      # sentinel centre
    props = make_random_features(P, rng)
    props[1, 0:2] = (4.0e5, -4.0e5)  # probes far out of bounds
    return depth, labels, props


def _unpack(bits, p):
    return np.stack([(bits[:, q // 32] >> (q % 32)) & 1 for q in range(p)],
                    axis=1).astype(bool)


def _jax_split_bits(depth, props):
    """f < thresh of every (pixel, proposal) from the JAX trainer's
    evaluator, as (N, P, H, W) bool."""
    n, h, w = depth.shape
    lin = np.arange(n * h * w, dtype=np.int32)
    f = np.asarray(_chunk_features(
        jnp.asarray(depth.reshape(-1)), jnp.asarray(lin // (h * w)),
        jnp.asarray((lin % (h * w)) // w), jnp.asarray(lin % w),
        jnp.asarray(depth.reshape(-1)), jnp.asarray(props), h, w))
    return (f < props[:, 4][:, None]).reshape(-1, n, h, w).transpose(1, 0, 2, 3)


def test_chunk_features_matches_jax(rng):
    depth, _, props = _inputs(rng)
    n, h, w = depth.shape
    lin = np.arange(n * h * w, dtype=np.int32)
    idx = [lin // (h * w), (lin % (h * w)) // w, lin % w]
    flat = depth.reshape(-1)
    want = np.asarray(_chunk_features(
        jnp.asarray(flat), *map(jnp.asarray, idx), jnp.asarray(flat),
        jnp.asarray(props), h, w))
    t = torch.as_tensor(flat.astype(np.int32))
    got = train_features.chunk_features(
        t, *map(torch.as_tensor, idx), t, torch.as_tensor(props), h, w)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("masked", [False, True])
def test_plain_bits_match_jax_features(rng, masked):
    depth, labels, props = _inputs(rng)
    active = labels > 0 if masked else None
    got = train_features.train_feature_bits_plain(
        torch.as_tensor(depth), torch.as_tensor(props),
        None if active is None else torch.as_tensor(active))
    assert got.dtype == torch.int32 and got.shape == (2, 2, 24, 40)
    got = _unpack(got.numpy(), P)
    want = _jax_split_bits(depth, props)
    if active is None:
        np.testing.assert_array_equal(got, want)
    else:
        sel = np.broadcast_to(active[:, None], got.shape)
        np.testing.assert_array_equal(got[sel], want[sel])
        assert not got[~sel].any()      # inactive pixels: all words 0
    assert got.any() and not got.all()


def test_plain_bits_match_pallas_interpret(rng):
    """The Pallas kernel pair B4 replaces, in interpret mode, with an active
    mask: bits agree on every active pixel (inactive ones are don't-care
    in JAX).  Its interpret-mode trace grows with P (about 80 s on a CPU at
    P = 40), so this comparison takes the first 6 proposals, the
    out-of-bounds one among them; the JAX suite holds the kernel equal to
    the JAX evaluator at P = 40, which the tests above compare with."""
    depth, labels, props = _inputs(rng)
    props = props[:6]
    active = labels > 0
    active[0, 3, 5] = active[1, 0, 0] = True
    want = np.asarray(train_feature_bits(
        jnp.asarray(depth), jnp.asarray(props), jnp.asarray(active),
        interpret=True))
    got = train_features.train_feature_bits_plain(
        torch.as_tensor(depth), torch.as_tensor(props),
        torch.as_tensor(active)).numpy()
    sel = np.broadcast_to(active[:, None], got.shape)
    np.testing.assert_array_equal(got[sel], want[sel])


def test_wrapper_on_cpu_is_the_plain_version(rng):
    depth, labels, props = _inputs(rng)
    d, p, a = (torch.as_tensor(x) for x in (depth.astype(np.int32), props,
                                            labels > 0))
    k = train_features_cuda.train_feature_bits_cuda
    before = k.launches
    got = k(d, p, a)
    assert k.launches == before
    assert torch.equal(got, train_features.train_feature_bits_plain(d, p, a))


def test_pack_bits_sign_word(rng):
    bits = torch.as_tensor(rng.random((33, 5)) < 0.5)
    bits[31] = True
    words = train_features.pack_bits(bits).numpy()
    assert words.shape == (2, 5) and (words[0] < 0).all()
    np.testing.assert_array_equal(_unpack(words[None], 33)[0], bits.numpy())



def test_plain_bits_match_jax_at_division_edge():
    """The division edge (kernel_bench.division_edge): every centre depth
    1..65534, offsets that are multiples of many depths or their float32
    neighbours, thresholds across the features' range.  The plain bits (the
    kernel's reference on the card) equal the JAX trainer's features."""
    depth, props = kernel_bench.division_edge(h=137, w=483)
    got = train_features.train_feature_bits_plain(
        torch.as_tensor(depth), torch.as_tensor(props)).numpy()
    want = _jax_split_bits(depth, props)
    np.testing.assert_array_equal(_unpack(got, props.shape[0]), want)
    assert want.any() and not want.all()


def _rn32_of_sum(q, p):
    """float32 RN of q + p, exactly: q float32, p a float64 (an exact
    product of two float32).  TwoSum gives s + e == q + p; s rounds as
    q + p does unless s is a float32 midpoint, where e's sign decides."""
    q64 = q.astype(np.float64)
    s = q64 + p
    bb = s - q64
    e = (q64 - (s - bb)) + (p - bb)
    c = s.astype(np.float32)
    lo = np.where(c.astype(np.float64) > s,
                  np.nextafter(c, np.float32(-np.inf)), c)
    hi = np.nextafter(lo, np.float32(np.inf))
    at_mid = s == (lo.astype(np.float64) + hi.astype(np.float64)) / 2
    return np.where(at_mid & (e > 0), hi, np.where(at_mid & (e < 0), lo, c))


def _quot(a, d):
    """csrc/forest_walk.cuh:quot in numpy, every rounding exact: y = RN(1/d),
    q = RN(a y), r = a - q d (an FMA: q d is exact in float64 and the
    difference cancels), RN(q + r y) (an FMA); IEEE division below
    |a| = 2^-90."""
    y = np.float32(1.0) / d
    q = (a * y).astype(np.float32)
    r64 = a.astype(np.float64) - q.astype(np.float64) * d.astype(np.float64)
    r = r64.astype(np.float32)
    assert (r.astype(np.float64) == r64).all()      # r is exact
    out = _rn32_of_sum(q, r.astype(np.float64) * y.astype(np.float64))
    return np.where(np.abs(a) < np.float32(2.0 ** -90), a / d, out)


def test_reciprocal_quotient_is_the_ieee_quotient_for_every_depth(rng):
    """The kernels' probe offsets divide by the centre depth d through one
    reciprocal per pixel and two fused multiply-adds (forest_walk.cuh:quot).
    For every d in 1..65535 and, per d, random proposal offsets (also
    scaled by 0.5, 0.25 and 2, as the layered model's probes are), the
    multiples k d with their float32 neighbours and halves, and values near
    and below the 2^-90 guard (where r leaves the normal range and the
    two multiply-adds alone would miss), the quotient must be the IEEE
    float32 quotient, bit for bit, so every floor equals the reference's."""
    d = np.arange(1, 65536, dtype=np.float32)[:, None]
    props = make_random_features(32, rng)[:, :4].reshape(-1)
    props = np.concatenate([props, props * np.float32(0.5),
                            props * np.float32(0.25), props * np.float32(2.0),
                            np.float32([0.0, -0.0, 2.0 ** -90, -2.0 ** -89,
                                        2.0 ** -91, 1e-30, 3.4e38, 1e-40,
                                        -3e-41, 2.0 ** -126, 7e-39,
                                        -2.0 ** -100])])
    ks = np.array([-1000, -849, -481, -3, -2, -1, 1, 2, 3, 5, 479, 480, 847,
                   848, 4097, 100003], np.float32)
    for lo in range(0, d.shape[0], 8192):
        dd = d[lo:lo + 8192]
        kd = (ks[None, :] * dd).astype(np.float32)
        a = np.concatenate(
            [np.broadcast_to(props, (dd.shape[0], props.size)), kd,
             np.nextafter(kd, np.float32(np.inf)),
             np.nextafter(kd, np.float32(-np.inf)),
             (kd * np.float32(0.5)).astype(np.float32)],
            axis=1).astype(np.float32)
        want = a / dd
        assert want.dtype == np.float32
        np.testing.assert_array_equal(_quot(a, dd), want)
