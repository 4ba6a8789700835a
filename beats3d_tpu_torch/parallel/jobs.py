"""Rank-side jobs of the multi-device paths, for :func:`.launch.spawn`.

A spawned rank imports its function afresh, by name, so the functions that
ranks run live here, in the port (a rank that imported a test module or a
script would load what that module imports).  :func:`run_jobs` runs a list
of jobs in every rank, each on a mesh of the shape it names, and returns a
dict of numpy results; each job function takes the mesh first and returns
host values, with this rank's kernel launches and collective bytes.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..ops import forest_eval_cuda, preproc_cuda, train_features_cuda
from .mesh import make_mesh

KERNELS = {"K1": forest_eval_cuda.evaluate_layered_cuda,
           "K2": preproc_cuda.plane_band_gauss_cuda,
           "B1": forest_eval_cuda.evaluate_forest_cuda,
           "B1_pdf_sum": forest_eval_cuda.forest_pdf_sum_cuda,
           "B4": train_features_cuda.train_feature_bits_cuda}


def _np(t):
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else t


def run_jobs(device, jobs):
    """Run ``jobs``, a list of (name, fn, (n_data, n_model), kwargs), in
    order on this rank: ``fn(mesh, **kwargs)`` on a mesh of that shape
    (meshes are made once per shape, in the same order on every rank).
    Returns {name: (result, launches, bytes_reduced, seconds)}: this
    rank's kernel launches and collective bytes in the job, and its wall
    time (host clock, synchronised)."""
    meshes, out = {}, {}
    for name, fn, shape, kwargs in jobs:
        if shape not in meshes:
            meshes[shape] = make_mesh(*shape, device=device)
        mesh = meshes[shape]
        before = {k: f.launches for k, f in KERNELS.items()}
        sent = mesh.bytes_reduced
        t0 = time.perf_counter()
        res = fn(mesh, **kwargs)
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)
        seconds = time.perf_counter() - t0
        out[name] = (res, {k: f.launches - before[k] for k, f in KERNELS.items()},
                     mesh.bytes_reduced - sent, seconds)
    return out


def describe_job(mesh):
    """The mesh as this rank sees it."""
    return dict(shape=mesh.shape, coords=mesh.coords, grid=mesh.grid.tolist(),
                backend=mesh.backend, device=str(mesh.device))


def eval_job(mesh, depth, forest, **kw):
    """Tree-sharded labels (:func:`.eval_sharded.evaluate_forest_sharded`)."""
    from .eval_sharded import evaluate_forest_sharded

    return _np(evaluate_forest_sharded(depth, forest, mesh, **kw))


def histogram_job(mesh, depth, labels, nodes, props, **kw):
    from .train_sharded import sharded_histogram_step

    return tuple(_np(t) for t in sharded_histogram_step(
        depth, labels, nodes, props, mesh, **kw))


def train_step_job(mesh, depth, labels, nodes, props, state, **kw):
    """``state``: (active, parent_counts, best_gain, best_params, best_left,
    best_right) numpy arrays."""
    from .train_sharded import sharded_train_step

    return tuple(_np(t) for t in sharded_train_step(
        depth, labels, nodes, props, *state, mesh, **kw))


def batch_job(mesh, model_cfg, intrin, cfg, frames, plane, *,
              group_min_size: float, axis: str = "data"):
    """``FramePipeline.batch_sharded`` with the layered model of
    ``model_cfg`` (a cfg.json path) loaded on this rank's device; its
    outputs and ``graph_replays``, the pipeline's CUDA graph replays on this
    rank (0 on the CPU)."""
    from ..models import LayeredDecisionForest
    from ..runtime.pipeline import FramePipeline

    model = LayeredDecisionForest.load(model_cfg, labels_reduce=cfg.labels_reduce,
                                       device=mesh.device)
    pipe = FramePipeline(model, intrin, cfg=cfg, group_min_size=group_min_size)
    out = pipe.batch_sharded(frames, plane, mesh, axis=axis)
    return dict({k: _np(v) for k, v in out.items()},
                graph_replays=np.int64(pipe.replays))


def trainer_job(mesh, depth, labels, *, num_classes: int, images_per_block: int,
                proposals_per_block: int, num_random_features: int,
                max_tree_depth: int, seed: int = 0, **trainer_kw):
    """One tree of the mesh ``DecisionTreeTrainer`` (``trainer_kw``:
    ``max_nodes_per_block``, ``streaming``, ``stream_codec``); returns its
    packed (2**D - 1, 7 + 2C) array."""
    from ..data.dataset import ArrayDataset
    from ..models.forest import DecisionTree
    from ..train import DecisionTreeTrainer

    ds = ArrayDataset(depth, labels, num_classes,
                      images_per_block=images_per_block)
    trainer = DecisionTreeTrainer(images_per_block, proposals_per_block,
                                  mesh=mesh, **trainer_kw)
    trainer.allocate(ds, num_random_features, max_tree_depth)
    tree = DecisionTree(max_tree_depth, num_classes)
    trainer.train(ds, tree, rng=np.random.default_rng(seed))
    return tree.data


def train_forest_job(mesh, train, test, *, num_classes: int, seed: int,
                     **cfg):
    """``train_forest(mesh=)``: ``train``/``test`` are (depth, labels, images
    per block) tuples; returns (forest array, pct_match, seconds per
    candidate tree from its log)."""
    from ..data.dataset import ArrayDataset
    from ..train import train_forest

    stamps = []
    forest = train_forest(
        ArrayDataset(train[0], train[1], num_classes, images_per_block=train[2]),
        ArrayDataset(test[0], test[1], num_classes), mesh=mesh,
        rng=np.random.default_rng(seed),
        log=lambda msg: stamps.append((time.perf_counter(), msg)), **cfg)
    starts = [t for t, m in stamps if m.startswith("training candidate")]
    starts.append(next(t for t, m in stamps if m.startswith("FOREST")))
    return (forest.data, forest.pct_match,
            [b - a for a, b in zip(starts, starts[1:])])
