"""Decision-forest training in PyTorch (counterpart of
beats3d_tpu/train/trainer.py).

Level-by-level greedy best-split search with the reference trainer's
behaviour and the JAX trainer's blocking, so one seed gives the same trees
in both packages:

* the same triple blocking: image blocks x proposal blocks x node blocks
  (at most ``max_nodes_per_block`` = 2^17 next-level nodes per pass); the
  same eligibility rule; the best gain merged across proposal blocks with a
  strict ``>``;
* split bits come from kernel B4 (:mod:`..ops.train_features_cuda`); its
  wrapper picks by the data's device: the kernel for CUDA tensors, its plain
  version for CPU tensors;
* the histogram counts left-child classes per (proposal, parent, class)
  over the compacted active pixels with integer ``bincount``s: exact counts,
  in any summation order (the JAX trainer's one-hot matmul and segment sum
  exist to feed the TPU's matrix unit);
* split selection (gini gain, zero-gain double leaf, >= 99.9 % purity
  cutoff, depth-limit leaves) runs on the data's device per proposal block;
  the per-level tree writes run on the host in numpy, verbatim the JAX
  trainer's;
* pixels advance through each new level by re-evaluating their node's
  chosen split.

``streaming=True`` keeps the blocks on the host and ships them per use:
run-length coded and decoded on the device (``stream_codec=True``, the
default), or plain with the node ids zlib-compressed on the host.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..models.forest import DecisionTree
from ..ops.train_features import pixel_features
from ..ops.train_features_cuda import train_feature_bits_cuda
from .proposals import make_random_features

CUTOFF_THRESH = 0.999  # the reference trainer's purity cutoff


# ---------------------------------------------------------------------------
# device steps
# ---------------------------------------------------------------------------

def histogram_step(bits, labels, nodes, *, num_classes: int, w2: int,
                   node_lo: int, num_props: int):
    """Child-class histogram of one (image block, proposal block, node
    block) from packed split bits.

    bits: (B, ceil(P/32), H, W) int32 from B4; labels: (B, H, W) integer;
    nodes: (B, H, W) int32, -1 = inactive.  ``w2`` parent slots cover the
    nodes [node_lo // 2, node_lo // 2 + w2).  Returns (left (P, w2, C),
    total (w2, C)) int64: left-child counts per proposal and left + right
    counts per parent.
    """
    c = num_classes
    bins = w2 * c
    dev = nodes.device
    b, p32, h, w = bits.shape
    node = nodes.reshape(-1).to(torch.int64)
    m_local = node - node_lo // 2
    idx = torch.nonzero((node >= 0) & (m_local >= 0) & (m_local < w2)).reshape(-1)
    col = m_local[idx] * c + labels.reshape(-1)[idx].to(torch.int64)
    total = torch.bincount(col, minlength=bins)
    words = bits.reshape(b, p32, h * w)[idx // (h * w), :, idx % (h * w)]
    left = torch.zeros(num_props * bins, dtype=torch.int64, device=dev)
    shifts = torch.arange(32, dtype=torch.int64, device=dev)
    for wd in range(p32):
        n_in = min(32, num_props - 32 * wd)
        is_left = ((words[:, wd][None, :] >> shifts[:n_in, None]) & 1) == 1
        key = (shifts[:n_in, None] + 32 * wd) * bins + col[None, :]
        left += torch.bincount(key[is_left], minlength=num_props * bins)
    return left.view(num_props, w2, c), total.view(w2, c)


def class_sum(x):
    """Sum over the last (class) axis as an explicit left-to-right loop, so
    the float32 rounding is the same on every device."""
    s = x[..., 0]
    for k in range(1, x.shape[-1]):
        s = s + x[..., k]
    return s


def gini_impurity(counts):
    """counts (..., C) float32 -> 1 - sum_k p_k^2.  An empty histogram gets
    a safe denominator; its impurity is masked out by the caller."""
    s = class_sum(counts)[..., None]
    pr = counts / torch.where(s == 0.0, 1.0, s)
    return 1.0 - class_sum(pr * pr)


def pick_best_step(active_nodes, parent_counts, left, total, props,
                   best_gain, best_params, best_left, best_right, *,
                   w2: int, parent_lo: int):
    """Merge one proposal block's gains into the per-active-node running
    best.

    active_nodes: (A,) int64; parent_counts: (A, C) float32; left:
    (P, w2, C) and total: (w2, C) integer counts; props: (P, 5).  best_*:
    running state (A,), (A, 5), (A, C), (A, C).  A node takes a block's
    best proposal (the first maximum) only on a strictly greater gain.
    """
    m_local = active_nodes - parent_lo
    eligible = (active_nodes >= 0) & (m_local >= 0) & (m_local < w2)
    m_safe = m_local.clamp(0, w2 - 1)

    l = left[:, m_safe, :].to(torch.float32)             # (P, A, C)
    t = total[m_safe, :].to(torch.float32)               # (A, C)
    r = t[None] - l

    lsum = class_sum(l)
    rsum = class_sum(r)
    psum = class_sum(parent_counts)                      # (A,)

    p_imp = gini_impurity(parent_counts)
    remainder = (lsum / psum[None]) * gini_impurity(l) + (
        rsum / psum[None]) * gini_impurity(r)
    g = p_imp[None] - remainder
    g = torch.where((lsum == 0) | (rsum == 0), 0.0, g)

    best_j = torch.argmax(g, dim=0)                      # first maximum
    arange_a = torch.arange(active_nodes.shape[0], device=g.device)
    g_best = g[best_j, arange_a]

    improve = eligible & (g_best > best_gain)
    return (
        torch.where(improve, g_best, best_gain),
        torch.where(improve[:, None], props[best_j], best_params),
        torch.where(improve[:, None], l[best_j, arange_a], best_left),
        torch.where(improve[:, None], r[best_j, arange_a], best_right),
    )


def advance_step(depth, nodes, level_params, level_status):
    """Move every active pixel to its child at the next level, or to -1
    where its side ended in a leaf.

    depth: (B, H, W) integer; nodes: (B, H, W) int32; level_params: (G, 5)
    float32 chosen splits; level_status: (G, 2) int32 floor(l_next/r_next).
    Returns the new (B, H, W) int32 node ids.
    """
    _, h, w = depth.shape
    depth_flat = depth.reshape(-1)
    nodes_flat = nodes.reshape(-1).to(torch.int64)
    idx = torch.nonzero(nodes_flat >= 0).reshape(-1)
    node = nodes_flat[idx]
    pr = level_params[node]                              # (A, 5)
    rem = idx % (h * w)
    f = pixel_features(depth_flat, idx // (h * w), rem // w, rem % w,
                       depth_flat[idx], pr[:, 0], pr[:, 1], pr[:, 2],
                       pr[:, 3], h, w)
    side = torch.where(f < pr[:, 4], 0, 1)
    status = level_status[node, side]
    out = torch.full_like(nodes_flat, -1)
    out[idx] = torch.where(status == -1, node * 2 + side, -1)
    return out.view(nodes.shape).to(torch.int32)


# ---------------------------------------------------------------------------
# host-side trainer
# ---------------------------------------------------------------------------

class DecisionTreeTrainer:
    """Streaming level-wise trainer (reference DecisionTreeTrainer)."""

    def __init__(
        self,
        num_images_per_image_block: int,
        num_proposals_per_proposal_block: int,
        max_nodes_per_block: int = 1 << 17,
        streaming: bool = False,
        stream_codec: bool = True,
        device="cuda",
    ):
        """``device`` holds the data and runs every step."""
        self.images_per_block = num_images_per_image_block
        self.proposals_per_block = num_proposals_per_proposal_block
        self.max_nodes_per_block = max_nodes_per_block
        self.streaming = streaming
        self.stream_codec = stream_codec
        self.device = torch.device(device)

    def allocate(self, dataset, num_random_features: int, max_tree_depth: int):
        assert dataset.num_images % self.images_per_block == 0
        assert num_random_features % self.proposals_per_block == 0
        self.num_random_features = num_random_features
        self.max_tree_depth = max_tree_depth
        self.num_image_blocks = dataset.num_images // self.images_per_block
        self.num_proposal_blocks = (
            num_random_features // self.proposals_per_block
        )

    def _upload(self, arr, dtype):
        """Host numpy block -> ``dtype`` tensor on the trainer's device."""
        return torch.as_tensor(np.array(arr)).to(self.device).to(dtype)

    # -- one tree ------------------------------------------------------------
    def train(self, dataset, tree: DecisionTree,
              rng: Optional[np.random.Generator] = None,
              proposals_per_level: Optional[List[List[np.ndarray]]] = None):
        """Train ``tree`` in place.  ``proposals_per_level`` (tests) injects
        fixed proposals: a list over levels of lists over proposal blocks
        of (P, 5) arrays."""
        rng = rng or np.random.default_rng()
        c = dataset.num_classes()
        d = self.max_tree_depth
        dev = self.device
        tree.data[:] = 0.0

        resident = not self.streaming
        depth_blocks, labels_blocks, nodes_blocks = [], [], []
        nodes_store = None
        # [depth, labels, nodes] DeviceCodecDynamic stores, built at the
        # first block once the shapes are known
        codec_stores = (
            [None, None, None] if (not resident and self.stream_codec) else None
        )
        if not resident and codec_stores is None:
            # the mutable node ids live zlib-compressed on the host and are
            # re-compressed after every level's advance
            from ..data.blocks import CompressedBlocksDynamic

            nodes_store = CompressedBlocksDynamic(
                self.num_image_blocks, self.images_per_block, dataset.img_dims)
        node_counts = np.zeros((1 << d, c), dtype=np.int64)
        for i in range(self.num_image_blocks):
            lab = dataset.get_labels_block(i)
            un, cnt = np.unique(lab, return_counts=True)
            for label_id, n in zip(un, cnt):
                if label_id > 0:
                    node_counts[0, label_id] += n
            nodes = np.full(lab.shape, -1, dtype=np.int32)
            nodes[lab > 0] = 0
            if resident:
                depth_blocks.append(
                    self._upload(dataset.get_depth_block(i), torch.int32))
                labels_blocks.append(self._upload(lab, torch.int32))
                nodes_blocks.append(self._upload(nodes, torch.int32))
            elif codec_stores is not None:
                db = np.asarray(dataset.get_depth_block(i))
                if codec_stores[0] is None:
                    from ..data.device_codec import DeviceCodecDynamic

                    codec_stores[:] = [
                        DeviceCodecDynamic(self.num_image_blocks, a.shape,
                                           a.dtype, dev)
                        for a in (db, lab, nodes)
                    ]
                codec_stores[0].write_block(i, db)
                codec_stores[1].write_block(i, np.asarray(lab))
                codec_stores[2].write_block(i, nodes)
            else:
                nodes_store.write_block(i, nodes)

        def fetch(ib):
            """(depth, labels, nodes) int32 device tensors of one block."""
            if resident:
                return depth_blocks[ib], labels_blocks[ib], nodes_blocks[ib]
            if codec_stores is not None:
                # decoded on the device: only the RLE buffers cross
                return tuple(s.get_block(ib).to(torch.int32)
                             for s in codec_stores)
            return (
                self._upload(dataset.get_depth_block(ib), torch.int32),
                self._upload(dataset.get_labels_block(ib), torch.int32),
                self._upload(nodes_store.get_block(ib), torch.int32),
            )

        p = self.proposals_per_block
        active = np.array([0], dtype=np.int64)

        for level in range(d):
            if len(active) == 0:
                break
            with torch.profiler.record_function(f"train level {level}"):
                a = len(active)
                active_t = torch.as_tensor(active, device=dev)
                parent_counts = torch.as_tensor(
                    node_counts[active].astype(np.float32), device=dev)

                best_gain = torch.full((a,), -1.0, dtype=torch.float32,
                                       device=dev)
                best_params = torch.zeros((a, 5), dtype=torch.float32,
                                          device=dev)
                best_left = torch.zeros((a, c), dtype=torch.float32, device=dev)
                best_right = torch.zeros((a, c), dtype=torch.float32,
                                         device=dev)

                max_next = 1 << (level + 1)
                if max_next > self.max_nodes_per_block:
                    assert max_next % self.max_nodes_per_block == 0
                    node_blocks = [
                        (i * self.max_nodes_per_block,
                         (i + 1) * self.max_nodes_per_block)
                        for i in range(max_next // self.max_nodes_per_block)
                    ]
                else:
                    node_blocks = [(0, max_next)]

                for pb in range(self.num_proposal_blocks):
                    if proposals_per_level is not None:
                        props_np = proposals_per_level[level][pb]
                    else:
                        props_np = make_random_features(p, rng)
                    props = torch.as_tensor(
                        np.ascontiguousarray(props_np, dtype=np.float32),
                        device=dev)

                    # split bits once per (proposal block, image block),
                    # reused across node blocks when the data is resident
                    bits_cache = {}

                    def feature_bits(ib, d_b, n_b):
                        if ib in bits_cache:
                            return bits_cache[ib]
                        bits = train_feature_bits_cuda(d_b, props, n_b >= 0)
                        if resident and len(node_blocks) > 1:
                            bits_cache[ib] = bits
                        return bits

                    for (lo, hi) in node_blocks:
                        w2 = (hi - lo) // 2
                        left = torch.zeros((p, w2, c), dtype=torch.int64,
                                           device=dev)
                        total = torch.zeros((w2, c), dtype=torch.int64,
                                            device=dev)
                        for ib in range(self.num_image_blocks):
                            d_b, l_b, n_b = fetch(ib)
                            l_i, t_i = histogram_step(
                                feature_bits(ib, d_b, n_b), l_b, n_b,
                                num_classes=c, w2=w2, node_lo=lo, num_props=p)
                            left += l_i
                            total += t_i

                        best_gain, best_params, best_left, best_right = (
                            pick_best_step(
                                active_t, parent_counts, left, total, props,
                                best_gain, best_params, best_left, best_right,
                                w2=w2, parent_lo=lo // 2,
                            )
                        )

                # -- finalize this level (host, few KB) ----------------------
                with torch.profiler.record_function("finalize"):
                    bg = best_gain.cpu().numpy()
                    bp = best_params.cpu().numpy()
                    bl = best_left.cpu().numpy()
                    br = best_right.cpu().numpy()
                    next_active = self._finalize_level(
                        tree, level, active, node_counts, bg, bp, bl, br, c, d)

                if level == d - 1 or not next_active:
                    break

                # -- advance pixels through the freshly written level --------
                lvl = tree.data[(1 << level) - 1 : (1 << (level + 1)) - 1]
                level_params = torch.as_tensor(
                    np.ascontiguousarray(lvl[:, 0:5]), device=dev)
                level_status = torch.as_tensor(
                    np.floor(lvl[:, 5:7]).astype(np.int64), device=dev)
                for ib in range(self.num_image_blocks):
                    d_b, _, n_b = fetch(ib)
                    advanced = advance_step(d_b, n_b, level_params,
                                            level_status)
                    if resident:
                        nodes_blocks[ib] = advanced
                    elif codec_stores is not None:
                        codec_stores[2].write_block(ib, advanced.cpu().numpy())
                    else:
                        nodes_store.write_block(ib, advanced.cpu().numpy())
                active = np.array(sorted(next_active), dtype=np.int64)

        return tree

    @staticmethod
    def _finalize_level(tree, level, active, node_counts, bg, bp, bl, br,
                        c, d):
        """Write one level's nodes into the packed tree (the JAX trainer's
        host finalize, verbatim); returns the next level's active nodes."""
        next_active = []
        for i, node in enumerate(active):
            flat = (1 << level) - 1 + int(node)
            tree.data[flat, 0:5] = bp[i]
            parent = node_counts[node].astype(np.float64)
            if bg[i] <= 0.0:  # no gain: double leaf w/ parent pdf
                psum = parent.sum()
                pdf = (parent / psum).astype(np.float32)
                tree.data[flat, 5] = 0.0
                tree.data[flat, 6] = 0.0
                tree.data[flat, 7 : 7 + c] = pdf
                tree.data[flat, 7 + c : 7 + 2 * c] = pdf
                continue
            for side, counts in ((0, bl[i]), (1, br[i])):
                child = int(node) * 2 + side
                col = 5 + side
                pdf0 = 7 + side * c
                ssum = counts.sum()
                frac = counts / ssum
                cut = -1
                for k in range(c):
                    if frac[k] >= CUTOFF_THRESH:
                        cut = k
                        break
                if cut > -1:
                    tree.data[flat, col] = 0.0
                    tree.data[flat, pdf0 + cut] = 1.0
                elif level == d - 1:
                    tree.data[flat, col] = 0.0
                    tree.data[flat, pdf0 : pdf0 + c] = frac.astype(np.float32)
                else:
                    tree.data[flat, col] = -1.0
                    node_counts[child] = counts.astype(np.int64)
                    next_active.append(child)
        return next_active
