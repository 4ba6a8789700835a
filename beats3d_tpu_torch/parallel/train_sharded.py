"""Forest-training steps on a (data, model) mesh (counterpart of
beats3d_tpu/parallel/train_sharded.py).

A rank histograms its proposal slice (``model``) over its image slice
(``data``): split bits from kernel B4, then the trainer's integer
``histogram_step``.  Counts are integers, so their sum over ``data`` is
exact in any order.  The best split of each node is merged over ``model``
as JAX merges it: the largest gain, exact ties to the lowest model index
(the lowest global proposal index, the single-device scan's first maximum),
then the winner's values picked by a masked sum.
"""

from __future__ import annotations

import torch

from ..ops.train_features_cuda import train_feature_bits_cuda
from ..train.trainer import histogram_step, pick_best_step
from .mesh import Mesh


def local_histogram(depth, labels, nodes, props, *, num_classes: int,
                    w2: int, node_lo: int):
    """(left (P, w2, C), total (w2, C)) int64 of one rank's image slice and
    proposal slice: B4's split bits, then ``trainer.histogram_step``."""
    bits = train_feature_bits_cuda(depth, props, nodes >= 0)
    return histogram_step(bits, labels, nodes, num_classes=num_classes, w2=w2,
                          node_lo=node_lo, num_props=props.shape[0])


def block_step(left, total, props, active, parent_counts, best, mesh: Mesh,
               *, parent_lo: int, w2: int):
    """The mesh trainer's step for one (proposal block, node block).

    Only the S active nodes inside the block's parent slots [parent_lo,
    parent_lo + w2) travel: their rows of this rank's left (P, w2, C) and
    total (w2, C) are summed over ``data``, this rank's best proposal per
    node is merged into the running best (``trainer.pick_best_step``), and
    the bests are merged over ``model`` (:func:`merge_best`).  ``best``:
    the running (gain, params, left, right) of all A active nodes, the same
    on every rank; returns it updated, with the nodes outside the block
    unchanged.  The active nodes are the same on every rank, so every rank
    makes the same collectives.
    """
    m_local = active - parent_lo
    sel = torch.nonzero((m_local >= 0) & (m_local < w2)).reshape(-1)
    s = sel.numel()
    if s == 0:
        return best
    rows = m_local[sel]
    left = mesh.all_reduce(left[:, rows], "data")
    total = mesh.all_reduce(total[rows], "data")
    local = pick_best_step(torch.arange(s, device=active.device),
                           parent_counts[sel], left, total, props,
                           *(b[sel] for b in best), w2=s, parent_lo=0)
    out = []
    for b, m in zip(best, merge_best(local, mesh)):
        b = b.clone()
        b[sel] = m
        out.append(b)
    return tuple(out)


def merge_best(best, mesh: Mesh):
    """Every node's best split over the ``model`` ranks: the largest gain,
    exact ties to the lowest model index; the winner's (gain, params,
    left, right) picked by one masked sum.  ``best``: this rank's (A,),
    (A, 5), (A, C), (A, C) float32; returns the merged tuple, the same on
    every rank of the axis."""
    g, params, lcounts, rcounts = best
    m = mesh.shape["model"]
    midx = mesh.index("model")
    tied = g == mesh.all_reduce(g, "model", "max")
    widx = mesh.all_reduce(
        torch.where(tied, midx, m).to(torch.int32), "model", "min")
    winner = tied & (widx == midx)
    packed = torch.cat([g[:, None], params, lcounts, rcounts], dim=1)
    packed = mesh.all_reduce(torch.where(winner[:, None], packed, 0.0), "model")
    c = lcounts.shape[1]
    return packed[:, 0], packed[:, 1:6], packed[:, 6:6 + c], packed[:, 6 + c:]


def _shards(mesh, depth, labels, nodes, props):
    """This rank's image slice (int32) and proposal slice (float32) on its
    device."""
    dev = mesh.device

    def img(x):
        x = mesh.shard(torch.as_tensor(x), "data")
        return x.to(dev, torch.int32).contiguous()

    pr = mesh.shard(torch.as_tensor(props), "model")
    return (img(depth), img(labels), img(nodes),
            pr.to(dev, torch.float32).contiguous())


def sharded_histogram_step(depth, labels, nodes, props, mesh: Mesh, *,
                           num_classes: int, w2: int, node_lo: int):
    """The distributed histogram: images sharded over ``data``, proposals
    over ``model``.

    depth/labels/nodes: the whole (B, H, W) block on every rank, B
    divisible by the data axis; props: (P, 5), P divisible by the model
    axis.  Returns (left (P, w2, C), total (w2, C)) int64, the same on
    every rank: summed over ``data``, left gathered over ``model``.
    """
    d, l, n, pr = _shards(mesh, depth, labels, nodes, props)
    left, total = local_histogram(d, l, n, pr, num_classes=num_classes,
                                  w2=w2, node_lo=node_lo)
    left = mesh.all_reduce(left, "data")
    total = mesh.all_reduce(total, "data")
    return mesh.all_gather(left, "model"), total


def sharded_train_step(depth, labels, nodes, props, active_nodes,
                       parent_counts, best_gain, best_params, best_left,
                       best_right, mesh: Mesh, *, num_classes: int, w2: int,
                       node_lo: int):
    """One distributed training step: this rank's histogram summed over
    ``data``, its proposal slice's best split per active node merged into
    the running best (``trainer.pick_best_step``), then the merge over
    ``model`` (:func:`merge_best`).  Inputs as
    :func:`sharded_histogram_step`, plus the trainer's running state
    (active (A,), parent_counts (A, C), best_* (A,), (A, 5), (A, C),
    (A, C)); returns the merged (gain, params, left, right), the same on
    every rank.
    """
    d, l, n, pr = _shards(mesh, depth, labels, nodes, props)
    left, total = local_histogram(d, l, n, pr, num_classes=num_classes,
                                  w2=w2, node_lo=node_lo)
    left = mesh.all_reduce(left, "data")
    total = mesh.all_reduce(total, "data")
    dev = mesh.device
    state = [torch.as_tensor(x).to(dev) for x in (
        active_nodes, parent_counts, best_gain, best_params, best_left,
        best_right)]
    local = pick_best_step(state[0].to(torch.int64), state[1], left, total, pr,
                           *state[2:], w2=w2, parent_lo=node_lo // 2)
    return merge_best(local, mesh)
