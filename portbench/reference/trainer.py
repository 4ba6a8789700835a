"""Decision-tree training, plain: the benchmark's reference for
``train_forest``'s candidate trees (kernel B4's split bits, the histograms,
the chosen splits, the leaf pdfs) and their held-out scoring (kernel B1).

A frozen copy of the port's trainer with its data resident on one device
(beats3d_tpu_torch/train/trainer.py, proposals.py and ops/train_features.py,
the plain version of B4), which trains byte-equal trees on every device
from the same generator state.  ``ftype`` is the type of the depth-
difference feature: float32, as the configuration states, or a lower one
for the control.  Imports nothing of the program.
"""

from __future__ import annotations

import numpy as np
import torch

from . import forest

MAX_UINT16 = 65535
PIXEL_CHUNK = 1 << 16
CUTOFF_THRESH = 0.999  # the reference trainer's purity cutoff
FEATURE_MAGNITUDE_MAX = 14.0
FEATURE_THRESHOLD_MAX = 11.0


def make_random_features(n: int, rng: np.random.Generator = None) -> np.ndarray:
    """(n, 5) float32 rows (ux, uy, vx, vy, thresh)."""
    rng = rng or np.random.default_rng()
    theta = rng.uniform(0.0, 2.0 * np.pi, size=(n, 2))
    mag = np.exp(rng.uniform(0.0, FEATURE_MAGNITUDE_MAX, size=(n, 2)))
    u = np.stack([np.cos(theta[:, 0]), np.sin(theta[:, 0])], -1) * mag[:, 0:1]
    v = np.stack([np.cos(theta[:, 1]), np.sin(theta[:, 1])], -1) * mag[:, 1:2]
    thresh = rng.choice([-1.0, 1.0], size=n) * np.exp(
        rng.uniform(0.0, FEATURE_THRESHOLD_MAX, size=n)
    )
    return np.concatenate([u, v, thresh[:, None]], axis=1).astype(np.float32)


def pixel_features(depth_flat, b, y, x, d_center, ux, uy, vx, vy,
                   h: int, w: int, ftype=torch.float32):
    """Depth-difference features at unit scale, all arguments broadcast
    together: pixel (b, y, x) of centre depth d_center with probe offsets
    u = (ux, uy), v = (vx, vy).  depth_flat: (N*H*W,) integer depth.
    Returns ``ftype``."""
    df = d_center.to(ftype)
    safe = torch.where(df == 0, 1.0, df).to(ftype)
    b, y, x = b.to(torch.int64), y.to(torch.int64), x.to(torch.int64)

    def probe(cx, cy):
        # the divisor is a tensor: IEEE division on every device
        ty = y + torch.floor(cy.to(ftype) / safe).to(torch.int64)
        tx = x + torch.floor(cx.to(ftype) / safe).to(torch.int64)
        inb = (ty >= 0) & (ty < h) & (tx >= 0) & (tx < w)
        lin = b * (h * w) + ty.clamp(0, h - 1) * w + tx.clamp(0, w - 1)
        vals = depth_flat[lin.clamp(0, depth_flat.shape[0] - 1)]
        return torch.where(inb, vals, MAX_UINT16).to(ftype)

    f = probe(ux, uy) - probe(vx, vy)
    return torch.where(df == 0, 0.0, f).to(ftype)


def pack_bits(bits):
    """(P, M) bool -> (ceil(P/32), M) int32, bit p % 32 of word p // 32."""
    p, m = bits.shape
    p32 = (p + 31) // 32
    padded = torch.zeros((p32 * 32, m), dtype=torch.int64, device=bits.device)
    padded[:p] = bits.to(torch.int64)
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    words = (padded.view(p32, 32, m) << shifts[None, :, None]).sum(dim=1)
    # two's complement: a set bit 31 is the int32 sign bit
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(torch.int32)


def feature_bits(depth, props, active, ftype=torch.float32,
                 chunk: int = PIXEL_CHUNK):
    """Packed split bits (N, ceil(P/32), H, W) int32 of every active
    (pixel, proposal): bit p % 32 of word p // 32 is ``f < thresh`` of
    proposal p; an inactive pixel's words are 0 (B4's plain version)."""
    n, h, w = depth.shape
    hw = h * w
    p32 = (props.shape[0] + 31) // 32
    dev = depth.device
    flat = depth.reshape(-1).to(torch.int32)
    out = torch.zeros((n, p32, hw), dtype=torch.int32, device=dev)
    idx = torch.nonzero(active.reshape(-1)).reshape(-1)
    for lo in range(0, idx.shape[0], chunk):
        i = idx[lo: lo + chunk]
        b = i // hw
        rem = i % hw
        px = [a[None, :] for a in (b, rem // w, rem % w, flat[i])]
        f = pixel_features(flat, *px, *(props[:, k: k + 1] for k in range(4)),
                           h, w, ftype)
        out[b, :, rem] = pack_bits(f < props[:, 4:5].to(ftype)).T
    return out.view(n, p32, h, w)


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


def add_rounded(x, y):
    """x + y computed in float64 (``x`` float64, ``y`` promoted) and rounded
    once to float32: one elementwise kernel on a card, which loads, adds
    and stores in those types."""
    out = torch.empty(torch.broadcast_shapes(x.shape, y.shape),
                      dtype=torch.float32, device=x.device)
    return torch.add(x, y, out=out)


def fma(a, b, c):
    """a * b + c in float32 with one rounding, as XLA's CPU code contracts
    the gain's products and sums into fused multiply-adds: computed in
    float64, where the product of two float32 values is exact, then
    rounded to float32 (the same bits on every device; it can differ from
    a true fused multiply-add only where the float64 sum itself rounds
    onto a float32 midpoint)."""
    return add_rounded(a.to(torch.float64) * b, c)


def sum_squares(x):
    """sum_k x_k^2 over the last axis as XLA's CPU code computes it: the
    first square rounded, then one fused multiply-add per class, left to
    right (``fma``'s rounding; the exact float64 squares are made once,
    so each class costs one kernel, as a float32 sum does)."""
    sq = x.to(torch.float64).square()
    s = x[..., 0] * x[..., 0]
    for k in range(1, x.shape[-1]):
        s = add_rounded(sq[..., k], s)
    return s


def gini_impurity(counts):
    """counts (..., C) float32 -> 1 - sum_k p_k^2.  An empty histogram gets
    a safe denominator; its impurity is masked out by the caller."""
    s = class_sum(counts)[..., None]
    pr = counts / torch.where(s == 0.0, 1.0, s)
    return 1.0 - sum_squares(pr)


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
    # one fused multiply-add, as XLA's CPU code computes it (ROADMAP C-w8)
    remainder = fma(lsum / psum[None], gini_impurity(l),
                    (rsum / psum[None]) * gini_impurity(r))
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


def advance_step(depth, nodes, level_params, level_status,
                 ftype=torch.float32):
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
                       pr[:, 3], h, w, ftype)
    side = torch.where(f < pr[:, 4].to(ftype), 0, 1)
    status = level_status[node, side]
    out = torch.full_like(nodes_flat, -1)
    out[idx] = torch.where(status == -1, node * 2 + side, -1)
    return out.view(nodes.shape).to(torch.int32)


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




def train_tree(depth, labels, num_classes: int, *, depth_limit: int,
               proposals: int, proposals_per_block: int,
               images_per_block: int, rng: np.random.Generator, device,
               ftype=torch.float32, max_nodes_per_block: int = 1 << 17):
    """One tree, as the program's resident trainer trains it from ``rng``:
    (N, H, W) uint16 ``depth`` and ``labels`` (0 = unlabelled) in blocks of
    ``images_per_block``; proposals drawn per level and proposal block.
    Returns the dense (2**D - 1, 7 + 2C) float32 tree."""
    c, d, dev = num_classes, depth_limit, torch.device(device)
    n_blocks = depth.shape[0] // images_per_block
    n_pblocks = proposals // proposals_per_block
    tree = np.zeros(((1 << d) - 1, 7 + 2 * c), np.float32)
    node_counts = np.zeros((1 << d, c), dtype=np.int64)
    depth_b, labels_b, nodes_b = [], [], []
    for i in range(n_blocks):
        sl = slice(i * images_per_block, (i + 1) * images_per_block)
        lab = labels[sl]
        un, cnt = np.unique(lab, return_counts=True)
        for label_id, k in zip(un, cnt):
            if label_id > 0:
                node_counts[0, label_id] += k
        nodes = np.full(lab.shape, -1, dtype=np.int32)
        nodes[lab > 0] = 0
        up = lambda a: torch.as_tensor(np.array(a)).to(dev).to(torch.int32)
        depth_b.append(up(depth[sl]))
        labels_b.append(up(lab))
        nodes_b.append(up(nodes))
    p = proposals_per_block
    active = np.array([0], dtype=np.int64)
    for level in range(d):
        if len(active) == 0:
            break
        a = len(active)
        active_t = torch.as_tensor(active, device=dev)
        parent_counts = torch.as_tensor(
            node_counts[active].astype(np.float32), device=dev)
        best = (torch.full((a,), -1.0, dtype=torch.float32, device=dev),
                torch.zeros((a, 5), dtype=torch.float32, device=dev),
                torch.zeros((a, c), dtype=torch.float32, device=dev),
                torch.zeros((a, c), dtype=torch.float32, device=dev))
        max_next = 1 << (level + 1)
        if max_next > max_nodes_per_block:
            node_blocks = [(i * max_nodes_per_block,
                            (i + 1) * max_nodes_per_block)
                           for i in range(max_next // max_nodes_per_block)]
        else:
            node_blocks = [(0, max_next)]
        for _ in range(n_pblocks):
            props = torch.as_tensor(np.ascontiguousarray(
                make_random_features(p, rng), dtype=np.float32), device=dev)
            bits_cache = {}
            for lo, hi in node_blocks:
                w2 = (hi - lo) // 2
                left = torch.zeros((p, w2, c), dtype=torch.int64, device=dev)
                total = torch.zeros((w2, c), dtype=torch.int64, device=dev)
                for ib in range(n_blocks):
                    if ib not in bits_cache:
                        bits_cache[ib] = feature_bits(
                            depth_b[ib], props, nodes_b[ib] >= 0, ftype)
                    l_i, t_i = histogram_step(
                        bits_cache[ib], labels_b[ib], nodes_b[ib],
                        num_classes=c, w2=w2, node_lo=lo, num_props=p)
                    left += l_i
                    total += t_i
                best = pick_best_step(active_t, parent_counts, left, total,
                                      props, *best, w2=w2, parent_lo=lo // 2)
        holder = type("Tree", (), {})()
        holder.data = tree
        next_active = _finalize_level(
            holder, level, active, node_counts,
            *(t.cpu().numpy() for t in best), c, d)
        if level == d - 1 or not next_active:
            break
        lvl = tree[(1 << level) - 1: (1 << (level + 1)) - 1]
        level_params = torch.as_tensor(np.ascontiguousarray(lvl[:, 0:5]),
                                       device=dev)
        level_status = torch.as_tensor(
            np.floor(lvl[:, 5:7]).astype(np.int64), device=dev)
        for ib in range(n_blocks):
            nodes_b[ib] = advance_step(depth_b[ib], nodes_b[ib],
                                       level_params, level_status, ftype)
        active = np.array(sorted(next_active), dtype=np.int64)
    return tree


def tree_accuracy(flat: np.ndarray, depth, labels, device, chunk: int = 2,
                  ftype=torch.float32, work=None):
    """Held-out pct_match of one dense tree (single-tree semantics: a pixel
    whose walk ends in no leaf stays unlabelled): matching pixels over
    labelled pixels, ``chunk`` images at a time.  ``work``, a dict, has the
    walk's pixel-level ``steps`` and ``leaf_hits`` added to it."""
    dev = torch.device(device)
    tables = forest.level_tables(torch.as_tensor(
        np.ascontiguousarray(flat[None], dtype=np.float32)).to(dev))
    match = labelled = 0
    for lo in range(0, depth.shape[0], chunk):
        d = torch.as_tensor(depth[lo: lo + chunk].astype(np.int32)).to(dev)
        visits = None if work is None else []
        pred = forest.evaluate_forest(d, tables, write_all_eligible=False,
                                      ftype=ftype,
                                      visits=visits).cpu().numpy()
        if visits:
            work["steps"] += sum(int(r.numel()) for r, _ in visits)
            work["leaf_hits"] += sum(int(l.numel()) for _, l in visits)
        truth = labels[lo: lo + chunk]
        match += int(np.sum(pred == truth))
        labelled += int(np.sum(truth > 0))
    return match / labelled if labelled else float("nan")
