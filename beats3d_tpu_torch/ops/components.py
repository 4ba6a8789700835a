"""Connected components + two-hand group selection on the device (counterpart
of beats3d_tpu/ops/components.py).

Algorithm: union-find to a fixpoint.  Each round runs 8 neighbour-min
propagations (shifts only), then two pointer-jumping compressions
``lab = lab[lab]`` (an index gather; the JAX package's one-hot matmul gather
is a TPU workaround).  Labels converge to the minimum linear index of each
4-connected component, whatever the order of work, so the result equals the
JAX package's exactly.  The fixpoint test is one device->host sync per
round.

Selection: components of size <= pct_thresh * num_pixels are discarded;
among the rest, the largest with centroid x < W/2 becomes group 1 ("right
hand": the image is mirrored) and the largest with centroid x >= W/2 group
2.  Ties go to the smaller root, the first maximum of ``argmax``.  Per-root
sums use ``scatter_add`` in float32, exact below 2**24.

Functions take a leading batch dimension or none.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def label_components(mask):
    """4-connected component labels of a boolean mask (..., H, W).

    Returns int64 labels of the same shape: for mask pixels the linear index
    (within its image) of the component root, the minimum index of the
    component; for background H*W.
    """
    lead = mask.shape[:-2]
    h, w = mask.shape[-2:]
    n = h * w
    m = mask.reshape(-1, h, w)
    b = m.shape[0]
    dev = mask.device
    lin = torch.arange(n, dtype=torch.int64, device=dev).view(1, h, w)
    big = n
    lab = torch.where(m, lin, big)

    def neighbor_min(img):
        pad = F.pad(img, (1, 1, 1, 1), value=big)
        nb = torch.minimum(
            torch.minimum(pad[:, :-2, 1:-1], pad[:, 2:, 1:-1]),
            torch.minimum(pad[:, 1:-1, :-2], pad[:, 1:-1, 2:]),
        )
        return torch.where(m, torch.minimum(img, nb), big)

    # flat per-image tables with a self-looping background slot at index n
    sentinel = torch.full((b, 1), big, dtype=torch.int64, device=dev)

    def compress(img):
        flat = torch.cat([img.reshape(b, n), sentinel], dim=1)
        jumped = torch.gather(flat, 1, img.reshape(b, n)).reshape(b, h, w)
        return torch.where(m, jumped, img)

    while True:
        prev = lab
        for _ in range(8):
            lab = neighbor_min(lab)
        lab = compress(compress(lab))
        if not bool((lab != prev).any()):
            break
    return lab.reshape(*lead, h, w)


def make_hand_groups(depth_small, pct_thresh):
    """Connected components on a small depth image + left/right hand
    selection.

    depth_small: (..., H, W) integer depth (the 1/8 mipmap level).
    pct_thresh: minimum component size as a fraction of the image (strictly
    greater passes).

    Returns groups (..., H, W) in the depth's dtype (1 right-hand component,
    2 left-hand component, 0 elsewhere) and g_info (..., 2, 3) float32 rows
    (size, centroid_x, centroid_y) for (right, left); size 0 = no group.
    """
    lead = depth_small.shape[:-2]
    h, w = depth_small.shape[-2:]
    n = h * w
    dev = depth_small.device
    mask = depth_small.reshape(-1, h, w).to(torch.int32) > 0
    b = mask.shape[0]
    labels = label_components(mask)

    seg = labels.reshape(b, n).clamp(max=n - 1)
    ones = mask.reshape(b, n).to(torch.float32)
    xs = torch.arange(w, dtype=torch.float32, device=dev).repeat(h)
    ys = torch.arange(h, dtype=torch.float32, device=dev).repeat_interleave(w)

    def seg_sum(vals):
        return torch.zeros((b, n), dtype=torch.float32, device=dev).scatter_add_(
            1, seg, vals)

    sizes = seg_sum(ones)
    sx = seg_sum(ones * xs)
    sy = seg_sum(ones * ys)
    safe_sizes = torch.where(sizes == 0, 1.0, sizes)
    cx = sx / safe_sizes
    cy = sy / safe_sizes

    n_f = torch.tensor(float(n), dtype=torch.float32, device=dev)
    surviving = sizes / n_f > torch.tensor(
        float(pct_thresh), dtype=torch.float32, device=dev)
    is_right = cx < (w / 2.0)
    right_score = torch.where(surviving & is_right, sizes, 0.0)
    left_score = torch.where(surviving & ~is_right, sizes, 0.0)
    r_root = torch.argmax(right_score, dim=1, keepdim=True)
    l_root = torch.argmax(left_score, dim=1, keepdim=True)

    def pick(t, idx):
        return torch.gather(t, 1, idx)[:, 0]

    r_size = pick(right_score, r_root)
    l_size = pick(left_score, l_root)
    lab = labels.reshape(b, n)
    groups = torch.zeros((b, n), dtype=torch.int32, device=dev)
    groups = torch.where((lab == r_root) & (r_size > 0)[:, None], 1, groups)
    groups = torch.where((lab == l_root) & (l_size > 0)[:, None], 2, groups)
    g_info = torch.stack([
        torch.stack([r_size, pick(cx, r_root), pick(cy, r_root)], dim=-1),
        torch.stack([l_size, pick(cx, l_root), pick(cy, l_root)], dim=-1),
    ], dim=1)
    return (groups.reshape(*lead, h, w).to(depth_small.dtype),
            g_info.reshape(*lead, 2, 3))
