"""A configuration's own reference model (``reference_model``, resolved by
``reference.models``): a module of routed experts, which the chain
composite cannot express, is what ``frames.reference``, the control and
``RefPipeline`` run when a configuration names it; a configuration without
the key runs ``reference.forest`` exactly as before."""

import json
import sys

import numpy as np
import pytest
import torch

from portbench import control
from portbench.lib import frames as fr
from portbench.lib import harness
from portbench.reference import forest, models
from portbench.traffic import scenes as traffic
from portbench.work import counts

from . import routed_reference
from .conftest import ROOT, SEED, small

CPU = torch.device("cpu")
NAME = "routed_toy"
TOY = {"seed": 5, "trees": 2, "depth": 3, "experts": 2, "classes": 7}


@pytest.fixture
def toy(tmp_path, monkeypatch):
    """The toy module under ``portbench/reference/routed_toy``, its model
    file, and its ``run_layered`` counting calls by ``ftype``."""
    path = tmp_path / "toy.json"
    path.write_text(json.dumps(TOY))
    monkeypatch.setitem(sys.modules, f"portbench.reference.{NAME}",
                        routed_reference)
    calls = []
    run = routed_reference.run_layered

    def counted(*a, **k):
        calls.append(k["ftype"])
        return run(*a, **k)

    monkeypatch.setattr(routed_reference, "run_layered", counted)

    def chain_not_run(*a, **k):
        raise AssertionError("forest.run_layered ran for a configuration "
                             "that names its own reference model")

    monkeypatch.setattr(forest, "run_layered", chain_not_run)
    return str(path), calls


def _toy_config(cell, path):
    _, _, cfg, wl = small(cell)
    wl["traffic"]["scenes"] = 2
    cfg.update(reference_model=NAME, model=path)
    # the toy's three walks (router, two experts) for the work counts
    cfg["layers"] = [{"classes": 3}, {"classes": 7}, {"classes": 7}]
    return cfg, wl


def _ctx(cfg, wl, cell):
    return harness.Ctx(cell, SEED, 1.0, False, CPU, "", cfg, wl, 0.0, ROOT)


def test_routed_experts_label_what_the_chain_leaves():
    _, _, cfg, wl = small("flagship.live")
    depth = torch.as_tensor(traffic.frames(wl["traffic"], SEED, cfg[
        "camera"])[0][:2].astype(np.int32))
    model = routed_reference.Routed(*routed_reference.draw(TOY), CPU)
    visits = []
    got = routed_reference.run_layered(depth, model, labels_reduce=2,
                                       visits=visits)
    chain = forest.run_layered(depth, routed_reference.as_chain(model, CPU),
                               labels_reduce=2)
    route = forest.evaluate_forest(depth, model.router, labels_reduce=2)
    to_two = route == 2
    assert (to_two & (got != 65535)).sum() > 100
    assert bool((chain[to_two] == 65535).all())
    assert torch.equal(chain[route == 1], got[route == 1])
    assert set(torch.unique(got).tolist()) <= set(range(1, 7)) | {65535}
    assert len(visits) == 3
    assert all(c["steps"] > 0 for c in map(counts.walk_counts, visits))


def test_frames_reference_runs_the_named_model(toy):
    path, calls = toy
    cell = "flagship.live"
    cfg, wl = _toy_config(cell, path)
    model, run = models.load(cfg, ROOT, CPU)
    assert isinstance(model, routed_reference.Routed)
    scenes, _ = traffic.frames(wl["traffic"], SEED, cfg["camera"])
    outs, work, _ = fr.reference(_ctx(cfg, wl, cell), scenes, 0)
    assert calls == [torch.float32] * len(scenes)
    assert any((o["labels"] != 65535).any() for o in outs.values())
    # one launch a frame, one walk count for each of the toy's forests
    for call in work:
        assert len(call) == 1 and len(call[0][1]) == 3
        assert fr.frame_ops(cfg, call, 1) > 0


def test_batched_reference_and_control_run_the_named_model(toy):
    path, calls = toy
    cell = "flagship.batch16"
    cfg, wl = _toy_config(cell, path)
    scenes, _ = traffic.frames(wl["traffic"], SEED, cfg["camera"])
    # the crops, and a rescue where a hand is too big for them
    fr.reference(_ctx(cfg, wl, cell), scenes, 0, batch=True)
    n = len(calls)
    assert n in (1, 2) and set(calls) == {torch.float32}
    checks = control.control(cfg, wl, SEED, CPU)
    assert calls[n:2 * n] == calls[:n]
    assert set(calls[2 * n:]) == {control.LOW}
    assert set(checks.table()) == set(wl["limits"])


def test_a_module_outside_the_reference_is_refused():
    for name in ("../run", "tests.routed_reference", "", 3):
        with pytest.raises(ValueError):
            models.module({"reference_model": name})


@pytest.mark.parametrize("cell,batch", [("flagship.live", False),
                                        ("flagship.batch16_rescue", True)])
def test_default_is_the_forest_chain(monkeypatch, cell, batch):
    """Without the key, the reference runs ``forest.run_layered`` itself on
    ``forest.Layered``; each call's labels and visits are those of a direct
    call on the same inputs."""
    _, _, cfg, wl = small(cell)
    wl["traffic"]["scenes"] = 2
    assert "reference_model" not in cfg
    model, run = models.load(cfg, ROOT, CPU)
    assert run is forest.run_layered and type(model) is forest.Layered
    seen = []
    direct = forest.run_layered

    def recorded(depth, model, **k):
        lab = direct(depth, model, **k)
        seen.append((depth.clone(), model, k, lab))
        return lab

    monkeypatch.setattr(forest, "run_layered", recorded)
    scenes, _ = traffic.frames(wl["traffic"], SEED, cfg["camera"])
    _, work, _ = fr.reference(_ctx(cfg, wl, cell), scenes, 0, batch=batch)
    launches = [l for call in (work if not batch else [work]) for l in call]
    assert len(seen) == len(launches) >= 1
    for (depth, m, k, lab), (shape, layer_counts) in zip(seen, launches):
        visits = []
        want = direct(depth, m, labels_reduce=k["labels_reduce"],
                      scale_factor=k["scale_factor"], ftype=k["ftype"],
                      visits=visits)
        assert k["ftype"] == torch.float32
        assert torch.equal(lab, want) and tuple(depth.shape) == shape
        assert layer_counts == [counts.walk_counts(v) for v in visits]
