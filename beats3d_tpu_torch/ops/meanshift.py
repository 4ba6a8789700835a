"""Per-class mean-shift mode finding over 2D pixel coordinates (counterpart of
beats3d_tpu/ops/meanshift.py).

Round 0 initialises each class mean to the centroid of its pixels; each
later round shifts by sum(p * diff) / sum(p) with
p = exp(-|diff|^2 / (2 * var^2)).  A class with no pixels yields NaN (the
reference's 0/0; callers treat NaN as absent).  When the denominator
underflows to 0 the mode holds its position.  Reductions run in float32, in
PyTorch's order, which differs from XLA's in the last bits.
"""

from __future__ import annotations

import torch


def mean_shift(labels, variances, *, num_classes: int, num_rounds: int = 6):
    """Per-class modes of label images.

    labels: (..., H, W) integer label images; 0 and 65535 are background.
    variances: (num_classes,) float32 per-class bandwidths.
    Returns (..., num_classes, 2) float32 (x, y) modes; NaN for absent
    classes.
    """
    lead = labels.shape[:-2]
    h, w = labels.shape[-2:]
    dev = labels.device
    l = labels.reshape(-1, 1, h, w).to(torch.int32)
    xs = torch.arange(w, dtype=torch.float32, device=dev).view(1, 1, 1, w)
    ys = torch.arange(h, dtype=torch.float32, device=dev).view(1, 1, h, 1)
    class_ids = torch.arange(1, num_classes + 1, dtype=torch.int32,
                             device=dev).view(1, -1, 1, 1)
    masks = (l == class_ids).to(torch.float32)          # (B, C, H, W)

    counts = masks.sum(dim=(2, 3))
    sum_x = (masks * xs).sum(dim=(2, 3))
    sum_y = (masks * ys).sum(dim=(2, 3))
    absent = counts == 0
    means = torch.stack([sum_x, sum_y], dim=-1) / torch.clamp(
        counts, min=1.0)[..., None]

    var = torch.as_tensor(variances, dtype=torch.float32, device=dev)
    two_var2 = (2.0 * (var * var)).view(1, -1, 1, 1)
    for _ in range(num_rounds - 1):
        dx = xs - means[..., 0, None, None]
        dy = ys - means[..., 1, None, None]
        dist_sq = dx * dx + dy * dy
        p = torch.exp(-dist_sq / two_var2) * masks
        denom = p.sum(dim=(2, 3))
        safe = torch.where(denom == 0.0, 1.0, denom)
        shift_x = (p * dx).sum(dim=(2, 3)) / safe
        shift_y = (p * dy).sum(dim=(2, 3)) / safe
        means = means + torch.stack([shift_x, shift_y], dim=-1)
    means = torch.where(absent[..., None], float("nan"), means)
    return means.reshape(*lead, num_classes, 2)
