"""The port's skinned-rig hands (beats3d_tpu_torch.data.rigged, a numpy copy)
and synth's rigged branch against the JAX package: the same clouds from the
same seeds, and articulated_scene(rigged=True) equal at 848x480 for the
flagship recipe's seeds."""

import numpy as np
import pytest

from beats3d_tpu.data import rigged as jrigged
from beats3d_tpu.data import synth as jsynth
from beats3d_tpu.utils import CameraIntrinsics
from beats3d_tpu_torch.data import rigged, synth
from beats3d_tpu_torch.utils.intrinsics import CameraIntrinsics as TIntrin


@pytest.mark.parametrize("seed,flex,detail", [(0, 1.0, 0.0), (7, 0.0, 0.0),
                                              (11, 1.0, 2.5)])
def test_rigged_hand_cloud_matches_jax(seed, flex, detail):
    want = jrigged.rigged_hand_cloud(np.random.default_rng(seed),
                                     flex_scale=flex, detail=detail)
    got = rigged.rigged_hand_cloud(np.random.default_rng(seed),
                                   flex_scale=flex, detail=detail)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("seed,two_hands", [(1001, False), (9901, False),
                                            (1001, True)])
def test_rigged_scene_matches_jax(seed, two_hands):
    want = jsynth.articulated_scene(CameraIntrinsics.d415(),
                                    np.random.default_rng(seed),
                                    two_hands=two_hands, rigged=True)
    got = synth.articulated_scene(TIntrin.d415(), np.random.default_rng(seed),
                                  two_hands=two_hands, rigged=True)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    depth, color = got
    assert (depth > 0).all()
    assert (color.sum(axis=-1) > 0).sum() > 5000     # a hand was drawn
