"""A run with the timed path broken underneath comes out not correct: for
each cell, each fault it can have (a step that returns its state
unchanged, half of the batch left out, an answer altered where it is
produced; no cell exchanges data between chips).  The runs skip the look
for a chip and drive the port's plain versions on the CPU at a small
size."""

import pytest

from beats3d_tpu_torch.runtime import pipeline
from beats3d_tpu_torch.train import trainer

from .conftest import run_small


def _clone(out):
    return {k: v.clone() for k, v in out.items()}


def _stale(method):
    """``method`` returning its first result on every later call."""
    first = {}

    def wrapped(self, *a, **k):
        if "out" not in first:
            first["out"] = method(self, *a, **k)
        return _clone(first["out"])
    return wrapped


def _altered(method):
    """``method`` with its first valid fingertip's height moved by 1."""
    def wrapped(self, *a, **k):
        out = _clone(method(self, *a, **k))
        h = out["heights"].reshape(-1)
        valid = out["tip_valid"].reshape(-1).nonzero()
        if len(valid):
            h[int(valid[0, 0])] += 1.0
        return out
    return wrapped


def _half(method):
    """``method`` with the second half of its batch left out."""
    def wrapped(self, *a, **k):
        out = _clone(method(self, *a, **k))
        b = out["heights"].shape[0]
        for v in out.values():
            v[b // 2:] = 0
        return out
    return wrapped


def test_clean_runs_are_correct():
    for cell in ("flagship.live", "flagship.live_idle", "flagship.batch16",
                 "flagship_fine_train.recipe"):
        res, table = run_small(cell)
        assert res["correct"], (cell, table)
        assert res["attempted"] >= 1 and res["failed"] == 0


def _lagged(method):
    """``method`` returning the result of its call before (its first call
    returns its own)."""
    prev = {}

    def wrapped(self, *a, **k):
        out = _clone(method(self, *a, **k))
        last = prev.get("out", out)
        prev["out"] = out
        return last
    return wrapped


# flagship.live_idle has a stretch of bare table, then one of hands: a
# tick that repeats a frame's answer shows where the hands come and go
@pytest.mark.parametrize("cell", ["flagship.live", "flagship.live_idle"])
@pytest.mark.parametrize("fault", [_stale, _lagged, _altered])
def test_live_faults(monkeypatch, fault, cell):
    monkeypatch.setattr(pipeline.FramePipeline, "__call__",
                        fault(pipeline.FramePipeline.__call__))
    res, table = run_small(cell)
    assert not res["correct"], table


@pytest.mark.parametrize("fault", [_stale, _altered, _half])
def test_batch_faults(monkeypatch, fault):
    monkeypatch.setattr(pipeline.FramePipeline, "batch",
                        fault(pipeline.FramePipeline.batch))
    res, table = run_small("flagship.batch16")
    assert not res["correct"], table


def _tree_unchanged(train):
    seen = {}

    def wrapped(self, dataset, tree, rng=None, **k):
        if "done" not in seen:
            seen["done"] = True
            return train(self, dataset, tree, rng, **k)
        # the generator still moves, the tree does not
        train(self, dataset, type(tree)(tree.max_depth, tree.num_classes),
              rng, **k)
        return tree
    return wrapped


def _half_the_images(train):
    def wrapped(self, dataset, tree, rng=None, **k):
        n = self.num_image_blocks
        self.num_image_blocks = max(1, n // 2)
        try:
            return train(self, dataset, tree, rng, **k)
        finally:
            self.num_image_blocks = n
    return wrapped


def _leaf_altered(train):
    def wrapped(self, dataset, tree, rng=None, **k):
        out = train(self, dataset, tree, rng, **k)
        leaf = (tree.data[:, 5] == 0) | (tree.data[:, 6] == 0)
        row = int(leaf.nonzero()[0][0])
        tree.data[row, 7] += 0.5
        return out
    return wrapped


@pytest.mark.parametrize("fault", [_tree_unchanged, _half_the_images,
                                   _leaf_altered])
def test_train_faults(monkeypatch, fault):
    monkeypatch.setattr(trainer.DecisionTreeTrainer, "train",
                        fault(trainer.DecisionTreeTrainer.train))
    res, table = run_small("flagship_fine_train.recipe", seconds=2.0)
    assert not res["correct"], table
