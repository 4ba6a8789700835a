"""Cells, configurations, drivers and metric readers are found by the
names in BENCHMARK.json, so that a later change adds them as files."""

import os

import numpy as np

from portbench.lib import harness


def test_every_cell_has_its_files():
    man = harness.manifest()
    for cell in man["workloads"]:
        wl = harness.load_json(os.path.join(harness.BENCH, "workloads",
                                            cell["name"] + ".json"))
        assert set(wl) == {"driver", "traffic", "limits"}
        assert callable(harness.driver(wl["driver"]).run)
        cfg = harness.load_json(os.path.join(harness.ROOT, harness.find(
            man["configs"], cell["config"], "configuration")["file"]))
        assert cfg["name"] == cell["config"]


def test_every_metric_has_a_reader_that_reads_nothing_from_nothing():
    man = harness.manifest()
    for m in man["end_to_end"] + man["per_layer"]:
        read = harness.reader(m["name"])
        assert read({}) is None, m["name"]
        assert read({"trace": None}) is None, m["name"]


def test_applies():
    man = {"end_to_end": [{"name": "a", "workloads": ["x"]},
                          {"name": "setup_s"}],
           "per_layer": []}
    assert harness.applies(man["end_to_end"][0], "x", man)
    assert not harness.applies(man["end_to_end"][0], "y", man)
    assert harness.applies(man["end_to_end"][1], "y", man)
    layer = {"name": "l", "moves": "a"}
    assert harness.applies(layer, "x", man)
    assert not harness.applies(layer, "y", man)


def test_sample_is_the_seeds():
    a = harness.sample(2 ** 33 + 1, 1, 4096, 24)
    assert a == harness.sample(2 ** 33 + 1, 1, 4096, 24)
    assert a != harness.sample(2 ** 33 + 2, 1, 4096, 24)
    assert len(a) == 24 and max(a) < 4096
    assert harness.sample(7, 3, 2, 5) == {0, 1}


def test_traffic_is_the_seeds():
    from portbench.traffic import scenes
    tr = {"scenes": 2, "seed_base": 1000, "seed_stride": 16,
          "two_hands": True, "flex_scale": 0.3,
          "height_range": [260.0, 420.0], "oversized": 1}
    cam = {"width": 424, "height": 240, "fx": 212.5, "fy": 212.5,
           "ppx": 212.0, "ppy": 120.0}
    a, big = scenes.frames(tr, 2 ** 33 + 9, cam)
    b, big2 = scenes.frames(tr, 2 ** 33 + 9, cam)
    assert a.shape == (2, 240, 424) and a.dtype == np.uint16
    assert (a == b).all() and list(big) == list(big2) and len(big) == 1
    c, _ = scenes.frames(tr, 2 ** 33 + 10, cam)
    assert (a != c).any()
