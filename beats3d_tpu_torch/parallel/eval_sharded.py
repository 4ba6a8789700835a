"""Forest evaluation on a (data, model) mesh (counterpart of
beats3d_tpu/parallel/eval_sharded.py): frames sharded over ``data``, trees
over ``model``, the per-pixel pdf sums combined with one all-reduce.

Float order: a shard sums its trees level by level in tree order (B1's
pdf-sum mode, bit for bit the plain version), and the shards' sums are then
added.  With 2 trees per shard and 2 shards that is one add per pixel and
class, the order of JAX's psum; with more than 2 shards on ``model`` the
all-reduce order is the backend's.  Against one device's sum over all trees
a label can differ only where the top two class sums lie within a few ulp.
"""

from __future__ import annotations

import torch

from ..ops.forest_eval import labels_from_pdf
from ..ops.forest_eval_cuda import forest_pdf_sum_cuda
from .mesh import Mesh


def evaluate_forest_sharded(depth, forest, mesh: Mesh, *,
                            labels_reduce: int = 1, scale_factor: float = 1.0):
    """Labels of a batch of depth frames on ``mesh``.

    depth: the whole (N, H, W) batch on every rank (tensor or numpy), N
    divisible by the ``data`` axis; forest: the dense (T, 2**D - 1, 7 + 2C)
    float32 forest, T divisible by the ``model`` axis.  This rank evaluates
    its frame slice with its contiguous tree slice (B1's pdf-sum mode on a
    card, the plain version on the CPU); the sums add over ``model``,
    all_done takes the minimum over ``model`` as int32 (JAX's pmin), and the
    labels of every frame slice are gathered over ``data``.  Returns the
    (N, H//r, W//r) int32 labels, 65535 where unlabelled, on the mesh's
    device.
    """
    depth = mesh.shard(torch.as_tensor(depth), "data")
    forest = mesh.shard(torch.as_tensor(forest), "model")
    pdf, eligible, all_done = forest_pdf_sum_cuda(
        depth.to(mesh.device, torch.int32).contiguous(),
        forest.to(mesh.device, torch.float32).contiguous(),
        labels_reduce=labels_reduce, scale_factor=scale_factor)
    pdf = mesh.all_reduce(pdf, "model")
    all_done = mesh.all_reduce(all_done.to(torch.int32), "model", "min") > 0
    return mesh.all_gather(labels_from_pdf(pdf, eligible, all_done), "data")
