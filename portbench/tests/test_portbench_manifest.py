"""BENCHMARK.json against the benchmark's contract: its keys, the names'
and units' characters, every metric's cells and the end-to-end metric it
moves, the files it names, the time a full check takes."""

import json
import os
import re

import pytest

from portbench.lib import harness

ROOT = harness.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\n\t]{1,200}$")


@pytest.fixture(scope="module")
def man():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        text = f.read()
    assert len(text.encode()) <= 64 * 1024
    return json.loads(text)


def test_keys(man):
    assert set(man) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert man["paths"] == ["portbench"]
    assert len(man["command"]) <= 32
    for w in man["command"]:
        assert LINE.match(w) and not w.startswith("/") and ".." not in w
    assert 1 <= man["run_seconds"] <= 51
    for c in man["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in man["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in man["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
    for m in man["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}


def test_names_units_and_lines(man):
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for it in man[group]:
            assert NAME.match(it["name"]), it["name"]
            names.append((group, it["name"]))
    assert len(set(names)) == len(names)
    metrics = [n for g, n in names if g in ("end_to_end", "per_layer")]
    assert len(set(metrics)) == len(metrics)
    for m in man["end_to_end"] + man["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for w in man["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert LINE.match(w["why"])
    for c in man["configs"]:
        assert LINE.match(c["why"]) and LINE.match(c["source"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for m in man["per_layer"]:
        assert LINE.match(m["layer"])


def test_sources_and_bounds(man):
    for m in man["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    setup = harness.find(man["end_to_end"], "setup_s", "metric")
    assert setup["bound"] <= 0.25 and "workloads" not in setup
    for m in man["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def test_cells_and_configs(man):
    cells = {w["name"] for w in man["workloads"]}
    configs = {c["name"] for c in man["configs"]}
    assert 1 <= len(cells) <= 24 and 1 <= len(configs) <= 24
    assert {w["config"] for w in man["workloads"]} == configs
    pairs = [(w["config"], w["traffic"]) for w in man["workloads"]]
    assert len(set(pairs)) == len(pairs)
    four = sum(w["chips"] == 4 for w in man["workloads"])
    assert all(w["chips"] in (1, 4) for w in man["workloads"])
    assert four <= max(1, len(cells) // 4)
    files = [c["file"] for c in man["configs"]]
    assert len(set(files)) == len(files)
    for f in files:
        assert f.startswith("portbench/") and os.path.isfile(
            os.path.join(ROOT, f))


def test_every_metric_reaches_its_cells(man):
    cells = {w["name"] for w in man["workloads"]}
    e2e = {m["name"]: m for m in man["end_to_end"]}
    for m in man["end_to_end"] + man["per_layer"]:
        assert set(m.get("workloads", ())) <= cells, m["name"]
    for m in man["per_layer"]:
        assert m["moves"] in e2e, m["name"]
        for cell in m.get("workloads", cells):
            assert harness.applies(e2e[m["moves"]], cell, man), (
                m["name"], cell)
    for cell in cells:
        got = [m["name"] for m in man["end_to_end"]
               if harness.applies(m, cell, man)]
        assert "setup_s" in got and len(got) >= 2, cell
        assert any(harness.applies(m, cell, man) for m in man["per_layer"])


def test_one_layer_name_per_layer(man):
    # metrics of one layer name it letter for letter alike
    layers = {m["layer"] for m in man["per_layer"]}
    by_word = {}
    for l in layers:
        by_word.setdefault(l.split(" (")[0], set()).add(l)
    assert all(len(v) == 1 for v in by_word.values()), by_word


def test_full_check_fits(man):
    # a full check of 24 cells: 2 + 14 runs a cell, each run_seconds + 60
    # s, 2 x 90 s a cell to compile, 1200 s spare, within 43200 s
    n = 24
    total = (2 + 14 * n) * (man["run_seconds"] + 60) + n * 180 + 1200
    assert total <= 43200
