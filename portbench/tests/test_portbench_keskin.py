"""The ``keskin_len`` configuration's reference model
(``reference/keskin_len.py``: Keskin et al.'s local expert network) and its
cell: the reference equals the port's test reference of routed models
(``tests/routed_plain.py``) on a small routed model, its visits feed the
work counts once per forest, and a run whose program takes one expert's
labels from its neighbour comes out not correct."""

import dataclasses
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from beats3d_tpu_torch.models import layered
from portbench.reference import keskin_len, models
from portbench.work import counts

from .conftest import ROOT, run_small, small

CPU = torch.device("cpu")
CELL = "keskin_len.batch16_shapes"


def _tests_module(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "tests", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _random_forest(rng, classes, depth=4, trees=2):
    n = 2 ** depth - 1
    f = np.zeros((trees, n, 7 + 2 * classes), np.float32)
    f[..., 0:4] = rng.uniform(-20000.0, 20000.0, (trees, n, 4))
    f[..., 4] = rng.normal(0.0, 300.0, (trees, n))
    leaf = rng.random((trees, n, 2)) < 0.3
    leaf[:, n // 2:] = True
    f[..., 5:7] = np.where(leaf, 0.0, -1.0)
    f[..., 7:] = rng.dirichlet(np.ones(classes), (trees, n, 2)).reshape(
        trees, n, 2 * classes)
    return f


def _write_routed(tmp_path, experts=3, classes=4, seed=9):
    """A coarse layer, a router and ``experts`` experts in the model
    format, with the condition rows that route."""
    rng = np.random.default_rng(seed)
    flats = [_random_forest(rng, 2), _random_forest(rng, experts + 1)] + [
        _random_forest(rng, classes) for _ in range(experts)]
    layers = [{"model": "m0.npy"},
              {"model": "m1.npy", "filter_model": 0, "filter_model_class": 1}]
    layers += [{"model": f"m{1 + k}.npy", "filter_model": 1,
                "filter_model_class": k} for k in range(1, experts + 1)]
    for i, f in enumerate(flats):
        np.save(os.path.join(tmp_path, f"m{i}.npy"), f)
    cfg = dict(layers=layers,
               conditions=[[1, 1, 1]] + [[1, 1 + experts, 1 + k]
                                         for k in range(1, experts + 1)]
               + [[0, c] for c in range(1, classes)],
               label_colors=[[255, 255, 255, 255]] * (classes - 1))
    path = os.path.join(tmp_path, "model_cfg.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path, flats


def _depth(rng, n, h, w):
    d = rng.integers(2000, 3000, (n, h, w)).astype(np.int32)
    d[rng.random((n, h, w)) < 0.1] = 0
    return torch.as_tensor(d)


def test_reference_equals_the_tests_reference(tmp_path):
    path, flats = _write_routed(str(tmp_path))
    model = keskin_len.load(path, CPU)
    assert model.conditions_np.shape == (1 + 3 + 3, 3)
    assert model.num_classes == 3
    depth = _depth(np.random.default_rng(2), 2, 40, 64)
    visits = []
    got = keskin_len.run_layered(depth, model, labels_reduce=2,
                                 visits=visits)
    plain = _tests_module("routed_plain")
    want, images = plain.run_routed(depth, flats[0], flats[1], flats[2:],
                                    r=2)
    assert torch.equal(got.to(torch.int64), want)
    assert ((images[1] >= 2) & (want != 65535)).any()
    # one walk a forest, in the file's layer order
    assert len(visits) == 5
    walks = [counts.walk_counts(v) for v in visits]
    walked = [int((im != 65535).sum()) for im in images]
    assert [w["leaf_hits"] > 0 for w in walks] == [n > 0 for n in walked]
    # the program's loader reads the same file as a routed model
    prog = layered.LayeredDecisionForest.load(path, labels_reduce=2,
                                              device="cpu")
    assert torch.equal(prog.run(depth).to(torch.int64), want)


def test_committed_model_walks_ten_forests():
    """The configuration's model file: ten walks, whose counts the work
    counts read with the classes the configuration lists."""
    _, _, cfg, _ = small(CELL)
    model, run = models.load(cfg, ROOT, CPU)
    assert run is keskin_len.run_layered
    assert model.conditions_np.shape[0] == cfg["condition_rows"]
    depth = _depth(np.random.default_rng(3), 1, 24, 32)
    visits = []
    run(depth, model, labels_reduce=2, visits=visits)
    assert len(visits) == len(cfg["layers"]) == 10
    by, ops = counts.k1_work((1, 24, 32), [counts.walk_counts(v)
                                           for v in visits],
                             [l["classes"] for l in cfg["layers"]],
                             cfg["condition_rows"], 2)
    assert by > 0 and ops > 0


def test_clean_run_is_correct():
    res, table = run_small(CELL)
    assert res["correct"], table


def _neighbours_expert(load):
    """``load`` whose routed model takes expert 2's labels from expert 3's
    forest (on expert 2's pixels)."""
    def wrapped(*a, **k):
        m = load(*a, **k)
        if m.counts is not None:
            e2, e3 = m.layers[3], m.layers[4]
            m.layers[3] = dataclasses.replace(
                e3, filter_model=e2.filter_model,
                filter_model_class=e2.filter_model_class)
        return m
    return staticmethod(wrapped)


def test_an_expert_with_its_neighbours_labels_is_not_correct(monkeypatch):
    monkeypatch.setattr(layered.LayeredDecisionForest, "load",
                        _neighbours_expert(layered.LayeredDecisionForest.load))
    res, table = run_small(CELL)
    assert not res["correct"], table
    assert table["labels_off"]["value"] > 0
