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
