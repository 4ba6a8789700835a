"""The traffic generator's cache of seed-independent frames: a run that
loads them gets what a run that renders them gets, the seed's order and
oversized frames applied after; a mix whose frames change with the seed
is never cached; the cells' cache names did not move when the
``bare_share`` key came.  ``bare_share``: the first share of the scenes is
the table alone, noisy where the mix is."""

import os

import numpy as np
import pytest

from portbench.lib import harness
from portbench.traffic import scenes as traffic
from portbench.traffic import synth

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


# the cache names of the cells' frames before the ``bare_share`` key existed
CACHE_NAMES = {
    "flagship.live": "frames-460ee5ded7d0c4a4e571bb5a.npz",
    "flagship.batch16": "frames-460ee5ded7d0c4a4e571bb5a.npz",
    "flagship.batch16_rescue": "frames-460ee5ded7d0c4a4e571bb5a.npz",
    "flagship_fine_train.recipe": "labelled-ace106a0f8a51dcd716c1141.npz",
}


def test_cache_names_of_mixes_without_bare_scenes_are_unchanged():
    man = harness.manifest()
    for cell, name in CACHE_NAMES.items():
        entry = harness.find(man["workloads"], cell, "cell")
        cfg = harness.load_json(os.path.join(harness.ROOT, harness.find(
            man["configs"], entry["config"], "configuration")["file"]))
        wl = harness.load_json(os.path.join(harness.BENCH, "workloads",
                                            cell + ".json"))
        kind = name.split("-")[0]
        assert traffic.cache_name(kind, wl["traffic"], cfg["camera"]) == name
    tr = wl["traffic"]
    assert traffic.cache_name("frames", dict(tr, bare_share=0.0),
                              cfg["camera"]) \
        != traffic.cache_name("frames", tr, cfg["camera"])


def test_bare_share():
    _, _, cfg, wl = small("flagship.live")
    tr, cam = dict(wl["traffic"], scenes=4, shuffle=False), cfg["camera"]
    assert "bare_share" not in tr and traffic.bare(tr) == 0
    hands, _ = traffic.frames(tr, SEED, cam)
    assert np.array_equal(
        traffic.frames(dict(tr, bare_share=0.0), SEED, cam)[0], hands)
    table, _ = synth.compose(synth.table_depth(traffic.camera(cam)), [])
    mixed, _ = traffic.frames(dict(tr, bare_share=0.5), SEED, cam)
    assert mixed.dtype == np.uint16
    assert all(np.array_equal(f, table) for f in mixed[:2])
    assert np.array_equal(mixed[2:], hands[2:])
    assert traffic.bare(dict(tr, bare_share=0.75)) == 3
    with pytest.raises(ValueError):
        traffic.frames(dict(tr, bare_share=1.5), SEED, cam)


def test_noise_comes_from_each_scene():
    _, _, cfg, wl = small("flagship.live")
    tr, cam = dict(wl["traffic"], scenes=3, shuffle=False), cfg["camera"]
    table, _ = synth.compose(synth.table_depth(traffic.camera(cam)), [])
    bare, _ = traffic.frames(dict(tr, bare_share=1.0, noise_scale=1.0),
                             SEED, cam)
    assert not any(np.array_equal(f, table) for f in bare)
    assert not np.array_equal(bare[0], bare[1])
    assert not np.array_equal(bare[1], bare[2])


def test_the_idle_cell_mixes_bare_and_hand_scenes():
    _, _, cfg, wl = small("flagship.live_idle")
    tr = wl["traffic"]
    assert traffic.bare(dict(tr, scenes=32)) == 16
    assert traffic.bare(tr) == 2 and tr["noise_scale"] > 0
    f, big = traffic.frames(tr, SEED, cfg["camera"])
    assert len(f) == 4 and not len(big)
    assert len({fr.tobytes() for fr in f}) == 4
    table, _ = synth.compose(synth.table_depth(traffic.camera(
        cfg["camera"])), [])
    # in order: the bare stretch first, then the hands
    raised = [((fr > 0) & (table.astype(np.int64) - fr > 100)).mean()
              for fr in f]
    assert [r > 0.01 for r in raised] == [False, False, True, True]
