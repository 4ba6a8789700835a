"""The frozen work counts against counts made by hand on tiny shapes."""

import numpy as np
import torch

from portbench.reference import forest
from portbench.work import counts


def _forest():
    """One tree of depth 2, 3 classes: the root's feature reads the pixel
    itself twice (f = 0) against threshold 1, so every pixel goes left and
    descends; node 0 of level 1 ends both sides in leaves."""
    c = 3
    flat = np.zeros((1, 3, 7 + 2 * c), np.float32)
    flat[0, 0, 4] = 1.0            # thresh
    flat[0, 0, 5] = -1.0           # left: descend
    flat[0, 0, 6] = 0.0            # right: leaf
    flat[0, 1, 4] = 1.0
    flat[0, 1, 7:7 + c] = [0.0, 1.0, 0.0]
    flat[0, 1, 7 + c:] = [0.0, 0.0, 1.0]
    return flat


def test_walk_counts_by_hand():
    depth = torch.full((1, 2, 2), 1000, dtype=torch.int32)
    visits = []
    pdf, elig, done = forest.forest_pdf_sum(
        depth, forest.level_tables(torch.as_tensor(_forest())),
        visits=visits)
    v = counts.walk_counts(visits)
    # level 0: 4 pixels read row 0; level 1: 4 read row 1 and stop at its
    # left leaf (slot 2 * 1 + 0)
    assert v == dict(rows=2, leaves=1, steps=8, leaf_hits=4)
    assert bool(done.all()) and pdf[0, 0, 0].tolist() == [0.0, 1.0, 0.0]
    by, ops = counts.k1_work((1, 2, 2), [v], [3], conditions_rows=1,
                             labels_reduce=1)
    assert by == 4 * 4 + 4 * 4 + 8 + 32 * 2 + 4 * 3 * 1
    assert ops == 9 * 8 + 3 * 4


def test_missing_pixels_are_not_walked():
    depth = torch.tensor([[[1000, 0], [65535, 1000]]], dtype=torch.int32)
    visits = []
    forest.forest_pdf_sum(depth, forest.level_tables(
        torch.as_tensor(_forest())), visits=visits)
    assert counts.walk_counts(visits) == dict(rows=2, leaves=1, steps=4,
                                              leaf_hits=2)


def test_k2_b4_and_bound():
    assert counts.k2_work(10) == (80, 1140)
    by, ops = counts.b4_work((2, 3, 5), 64, active_pixels=7)
    assert by == 4 * 30 + 5 * 4 * 64 + 30 + 4 * 2 * 2 * 15
    assert ops == 10 * 7 * 64
    s, what = counts.bound_s(3.35e12, 1.0)
    assert what == "bytes" and abs(s - 1.0) < 1e-12
    s, what = counts.bound_s(1.0, 67e12 * 2)
    assert what == "operations" and abs(s - 2.0) < 1e-12
