"""Colour palette ops of the datagen pipeline in plain PyTorch (counterpart
of beats3d_tpu/ops/colors.py): nearest-colour assignment, per-colour
statistics and the k-means (EM) palette fit.

Squared RGB distances are summed over the three channels as a chain of
multiply-adds, each rounded once to float32 (emulated in float64), which
is what the JAX package's fused program computes on the CPU; the card
computes it the same way.  Ties go to the first colour (``argmin``).

Per-colour counts and RGB sums are taken in int64: the pixel values are
integers, so the sums are exact and independent of the order of the
updates (a float32 ``index_add_`` on the card is atomic and would change
its last bits from run to run).  They equal the JAX package's float32 sums
wherever those are exact, below 2**24.
"""

from __future__ import annotations

import torch


def squared_distances(img, pal):
    """(..., K) float32 squared distances of (..., 3) pixels to a (K, 3)
    palette: fma(d2, d2, fma(d1, d1, d0 * d0)) with d = pixel - colour."""
    d = img.to(torch.float32)[..., None, :] - pal.to(torch.float32)
    acc = d[..., 0] * d[..., 0]
    for c in (1, 2):
        dc = d[..., c].to(torch.float64)
        acc = (dc * dc + acc.to(torch.float64)).to(torch.float32)
    return acc


def nearest_color_idx(image, colors):
    """Per-pixel index of the nearest palette colour (first of equals)."""
    return torch.argmin(squared_distances(image, colors), dim=-1)


def _non_black(image):
    return image.to(torch.int32).sum(dim=-1) != 0


def apply_point_mapping(image, colors):
    """Snap each non-black RGB pixel to its nearest palette colour; black
    pixels pass through.  image (..., 3) uint8, colors (K, 3) uint8."""
    colors = colors.to(image.device)
    snapped = colors[nearest_color_idx(image, colors)]
    return torch.where(_non_black(image)[..., None], snapped, image)


def _segment_stats(img, seg, k: int):
    """(counts (k,) int64, RGB sums (k, 3) int64) of the int pixels
    ``img`` (N, 3) over segments ``seg`` (N,) in 0..k (k = parked)."""
    counts = torch.bincount(seg, minlength=k + 1)[:k]
    sums = torch.zeros((k + 1, 3), dtype=torch.int64, device=img.device)
    sums.index_add_(0, seg, img.to(torch.int64))
    return counts, sums[:k]


def split_pixels_by_nearest_color(image, colors):
    """Per-colour statistics of the nearest-colour assignment over the
    non-black pixels: (counts (K,), RGB sums (K, 3), cost (K,)), all
    float32 as the JAX package returns them.  Counts and sums are exact;
    the cost (the sum of each pixel's squared distance) is a float32 sum
    per colour, in PyTorch's order."""
    k = colors.shape[0]
    img = image.reshape(-1, 3)
    d = squared_distances(img, colors)
    idx = torch.argmin(d, dim=-1)
    valid = _non_black(img)
    seg = torch.where(valid, idx, k)
    counts, sums = _segment_stats(img, seg, k)
    best = torch.gather(d, 1, idx[:, None])[:, 0]
    ks = torch.arange(k, device=img.device)
    cost = torch.where(seg[:, None] == ks, best[:, None], 0.0).sum(dim=0)
    return counts.to(torch.float32), sums.to(torch.float32), cost


def kmeans_palette_step(image, colors, num_iters: int = 32):
    """One EM restart: ``num_iters`` rounds of assign + recentre from the
    (K, 3) starting palette.  A colour that loses every pixel is reseeded
    (one per round, the first such) at the colour of the pixel farthest
    from its nearest colour.  Returns (palette (K, 3) float32, total
    cost, a float32 scalar tensor)."""
    img_i = image.reshape(-1, 3)
    img = img_i.to(torch.float32)
    valid = _non_black(img_i)
    pal = colors.to(device=img.device, dtype=torch.float32)
    k = pal.shape[0]
    for _ in range(num_iters):
        d = squared_distances(img, pal)
        min_d, idx = torch.min(d, dim=-1)
        seg = torch.where(valid, idx, k)
        counts, sums = _segment_stats(img_i, seg, k)
        cf = counts.to(torch.float32)
        new = sums.to(torch.float32) / torch.where(cf == 0, 1.0, cf)[:, None]
        new = torch.where((counts > 0)[:, None], new, pal)
        dead = counts == 0
        far = torch.argmax(torch.where(valid, min_d, -1.0))
        first_dead = torch.argmax(dead.to(torch.int32))
        row = torch.where(dead.any(), img[far], new[first_dead])
        new = new.index_put((first_dead[None],), row[None])
        pal = new
    best = squared_distances(img, pal).min(dim=-1).values
    cost = torch.where(valid, best, 0.0).sum()
    return pal, cost
