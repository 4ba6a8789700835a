"""The traffic generator's cache of seed-independent frames: a run that
loads them gets what a run that renders them gets, the seed's order and
oversized frames applied after; a mix whose frames change with the seed
is never cached."""

import numpy as np

from portbench.traffic import scenes as traffic

from .conftest import SEED, small


def test_cached_frames_equal_rendered(tmp_path):
    _, _, cfg, wl = small("flagship.batch16_rescue")
    tr, cam = wl["traffic"], cfg["camera"]
    want, want_big = traffic.frames(tr, SEED, cam)
    first, _ = traffic.frames(tr, SEED + 1, cam, cache=str(tmp_path))
    assert len(list(tmp_path.iterdir())) == 1
    got, got_big = traffic.frames(tr, SEED, cam, cache=str(tmp_path))
    assert np.array_equal(got, want) and np.array_equal(got_big, want_big)
    assert len(list(tmp_path.iterdir())) == 1


def test_cached_labelled_frames_equal_rendered(tmp_path):
    _, _, cfg, wl = small("flagship_fine_train.recipe")
    tr, cam = wl["traffic"], cfg["camera"]
    want = traffic.labelled_frames(tr, SEED, cam)
    for _ in range(2):
        got = traffic.labelled_frames(tr, SEED, cam, cache=str(tmp_path))
        for g, w in zip(got, want):
            assert all(np.array_equal(a, b) for a, b in zip(g, w))


def test_seeded_frames_not_cached(tmp_path):
    _, _, cfg, wl = small("flagship.live")
    tr = dict(wl["traffic"], seed_stride=16)
    a, _ = traffic.frames(tr, SEED, cfg["camera"], cache=str(tmp_path))
    b, _ = traffic.frames(tr, SEED + 1, cfg["camera"], cache=str(tmp_path))
    assert not list(tmp_path.iterdir())
    assert not np.array_equal(a, b)
