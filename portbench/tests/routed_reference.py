"""A toy reference model of routed experts, named by a test's configuration
under ``reference_model`` (``reference.models``): a router forest sends
each pixel to one of K sibling expert forests, as in Keskin et al.'s local
expert network (ECCV 2012), which the chain composite of
``reference.forest`` cannot express:

    label(x) = argmax_c sum_t P_{E_r(x), t}(c | x),
    r(x)     = argmax_k sum_t P_{R, t}(k | x)      (k = 0: no expert)

Its model file is a JSON object of sizes and a seed (``seed``, ``trees``,
``depth``, ``experts``, ``classes``); the forests are drawn from the seed.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from portbench.reference import forest

MAX_UINT16 = forest.MAX_UINT16


def random_forest(rng, trees: int, depth: int, classes: int) -> np.ndarray:
    """A dense (T, 2**D - 1, 7 + 2C) forest: probes of up to about 20 px at
    the table's depth, thresholds of a few hundred depth units, leaves on
    the last level, random leaf pdfs."""
    n = 2 ** depth - 1
    f = np.zeros((trees, n, 7 + 2 * classes), np.float32)
    f[..., 0:4] = rng.uniform(-60000.0, 60000.0, (trees, n, 4))
    f[..., 4] = rng.normal(0.0, 300.0, (trees, n))
    f[:, : n // 2, 5:7] = -1.0          # inner rows descend on both sides
    f[..., 7:] = rng.dirichlet(np.ones(classes), (trees, n, 2)).reshape(
        trees, n, 2 * classes)
    return f


class Routed:
    """A router forest of K + 1 classes and K expert forests of C classes
    (final classes 1..C-1)."""

    def __init__(self, router: np.ndarray, experts, device):
        self.flats = [router] + list(experts)
        dev = torch.device(device)
        self.router = forest.level_tables(torch.as_tensor(router).to(dev))
        self.experts = [forest.level_tables(torch.as_tensor(e).to(dev))
                        for e in experts]
        self.num_classes = forest.forest_dims(experts[0].shape)[2] - 1
        self.conditions_np = np.zeros((0, 2), np.int32)


def draw(sizes: dict):
    """(router, experts) of a model file's sizes, drawn from its seed."""
    rng = np.random.default_rng(sizes["seed"])
    router = random_forest(rng, sizes["trees"], sizes["depth"],
                           sizes["experts"] + 1)
    experts = [random_forest(rng, sizes["trees"], sizes["depth"],
                             sizes["classes"])
               for _ in range(sizes["experts"])]
    return router, experts


def load(config_path: str, device) -> Routed:
    with open(config_path) as f:
        return Routed(*draw(json.load(f)), device)


def run_layered(depth, model: Routed, *, labels_reduce: int,
                scale_factor: float = 1.0, visits=None, ftype=torch.float32):
    """The router, then each expert on the pixels routed to it; a pixel
    takes its expert's label (65535 where unrouted, or where its expert
    says class 0).  ``visits`` receives the router's walk, then each
    expert's."""
    kw = dict(labels_reduce=labels_reduce, scale_factor=scale_factor,
              ftype=ftype)

    def walk(tables, **more):
        lv = None if visits is None else []
        pdf, eligible, done = forest.forest_pdf_sum(depth, tables, visits=lv,
                                                    **kw, **more)
        if visits is not None:
            visits.append(lv)
        return forest.labels_from_pdf(pdf, eligible, done)

    route = walk(model.router)
    out = torch.full_like(route, MAX_UINT16)
    for k, tables in enumerate(model.experts, start=1):
        lab = walk(tables, filter_images=route, filter_class=k)
        out = torch.where((route == k) & (lab != 0) & (lab != MAX_UINT16),
                          lab, out)
    return out


def as_chain(model: Routed, device) -> forest.Layered:
    """The same forests as a 3d-beats chain (router, then expert 1 on the
    router's class 1, expert 2 on its class 2, ...): the chain composite
    reads layer l at step l, so it reaches expert 1 only."""
    c = model.num_classes
    k = len(model.experts)
    conditions = [(1, k)] * k + [(0, i) for i in range(1, c + 1)]
    layers = [(model.flats[0], None, None)] + [
        (e, 0, i) for i, e in enumerate(model.flats[1:], start=1)]
    return forest.Layered(layers, np.array(conditions, np.int32), device)
