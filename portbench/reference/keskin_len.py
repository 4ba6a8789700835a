"""The plain reference of the ``keskin_len`` configuration: Keskin et al.'s
local expert network (Hand Pose Estimation and Hand Shape Classification
Using Multi-layered Randomized Decision Forests, ECCV 2012).  A coarse
forest finds the hand, a router forest sends each hand pixel to one of K
expert part forests, and the pixel takes its expert's class:

    c(x)     = argmax_c sum_t P_{coarse,t}(c | x)
    r(x)     = argmax_k sum_t P_{R,t}(k | x)          where c(x) = hand
    label(x) = argmax_c sum_t P_{E_r(x),t}(c | x)     where r(x) >= 1

(k = 0: no expert; an expert's class 0, or none, leaves the pixel at
65535).  Written from these equations over the forests of the model file
(``reference.forest``'s walk): it reads the file's layers and filters,
not its condition rows, and imports nothing of the program.  The model's
contract is ``reference.models``'.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from portbench.reference import forest

MAX_UINT16 = forest.MAX_UINT16


class Experts:
    """The coarse layer, its hand class, the router and the experts (by
    router class, in the file's layer order) as level tables; the number
    of final classes; the file's condition rows (their count decides the
    incoherence guard, as the program's)."""

    def __init__(self, config_path: str, device):
        with open(config_path) as f:
            cfg = json.load(f)
        root = os.path.dirname(os.path.abspath(config_path))
        layers = cfg["layers"]
        dev = torch.device(device)

        def tables(i):
            return forest.level_tables(torch.as_tensor(forest.load_flat(
                os.path.join(root, layers[i]["model"]))).to(dev))

        free = [i for i, l in enumerate(layers) if "filter_model" not in l]
        on = {}
        for i, l in enumerate(layers):
            if "filter_model" in l:
                on.setdefault(int(l["filter_model"]), []).append(i)
        if free != [0] or len(on.get(0, ())) != 1:
            raise ValueError("want one coarse layer (0) and one router on it")
        router = on[0][0]
        self.hand = int(layers[router]["filter_model_class"])
        self.order = [0, router] + on.get(router, [])
        if sorted(self.order) != list(range(len(layers))):
            raise ValueError("want every other layer an expert on the router")
        self.coarse = tables(0)
        self.router = tables(router)
        self.experts = [(int(layers[i]["filter_model_class"]), tables(i))
                        for i in on.get(router, [])]
        self.num_classes = len(cfg["label_colors"])
        rows = cfg["conditions"]
        self.conditions_np = np.array([list(r) + [-1] * (3 - len(r))
                                       for r in rows], np.int32)


def load(config_path: str, device) -> Experts:
    return Experts(config_path, device)


def run_layered(depth, model: Experts, *, labels_reduce: int,
                scale_factor: float = 1.0, visits=None, ftype=torch.float32):
    """The final labels (N, H//r, W//r) int32 of an (N, H, W) depth stack;
    ``visits`` receives the walks of the coarse layer, the router and each
    expert, in the file's layer order."""
    kw = dict(labels_reduce=labels_reduce, scale_factor=scale_factor,
              ftype=ftype)

    def walk(tables, **more):
        lv = None if visits is None else []
        pdf, eligible, done = forest.forest_pdf_sum(depth, tables, visits=lv,
                                                    **kw, **more)
        if visits is not None:
            visits.append(lv)
        return forest.labels_from_pdf(pdf, eligible, done)

    coarse = walk(model.coarse)
    route = walk(model.router, filter_images=coarse, filter_class=model.hand)
    out = torch.full_like(route, MAX_UINT16)
    for k, tables in model.experts:
        lab = walk(tables, filter_images=route, filter_class=k)
        out = torch.where((route == k) & (lab != 0) & (lab != MAX_UINT16),
                          lab, out)
    return out.to(torch.int32)
