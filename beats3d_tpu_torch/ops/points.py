"""Per-frame point and image ops in plain PyTorch (counterpart of
beats3d_tpu/ops/points.py).

Conventions: depth images are (H, W) or (N, H, W) integer tensors with
0 = missing and 65535 = "missing for the forest"; point clouds are (..., 4)
float32 with w == 1 marking a valid point.  Functions take uint16 (the JAX
package's dtype) or the int32 the pipeline carries, compute in int32 /
float32, and return images in their input's dtype.

The JAX package's ``crop_mm`` / ``scatter_mm`` (one-hot matmuls that keep
dynamic crops on the TPU's matrix unit) have no counterpart: the port crops
by slicing and places crops by slice assignment, which is bit-identical.

Divisions by intrinsics go through tensors, never Python scalars: CUDA
computes ``tensor / python_float`` as a multiplication by the reciprocal,
which is not IEEE division.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

MAX_UINT16 = 65535


def _f32(v, device):
    return torch.as_tensor(v, dtype=torch.float32, device=device)


def deproject_points(depth, pp, focal):
    """Depth image -> camera-space float4 point cloud: for d > 0,
    p = (d*(x-ppx)/f, d*(y-ppy)/f, d, 1), else all zero.
    depth (..., H, W) -> (..., H, W, 4) float32."""
    h, w = depth.shape[-2:]
    dev = depth.device
    pp = _f32(pp, dev)
    f = _f32(focal, dev)
    x = torch.arange(w, dtype=torch.float32, device=dev).view(1, w)
    y = torch.arange(h, dtype=torch.float32, device=dev).view(h, 1)
    d = depth.to(torch.float32)
    px = d * (x - pp[0]) / f
    py = d * (y - pp[1]) / f
    pts = torch.stack([px, py, d, torch.ones_like(d)], dim=-1)
    return torch.where((d > 0)[..., None], pts, 0.0)


def plane_band_depth(depth, mat, pp, focal, threshold):
    """Fused deproject -> plane transform -> band filter -> depth: keep a
    pixel when d > 0 and its plane-space z is not above -threshold, with
    z = ((m20*px + m21*py) + m22*d) + m23 in that order.
    depth (..., H, W) -> (..., H, W), 0 where missing or cut."""
    h, w = depth.shape[-2:]
    dev = depth.device
    pp = _f32(pp, dev)
    f = _f32(focal, dev)
    x = torch.arange(w, dtype=torch.float32, device=dev).view(1, w)
    y = torch.arange(h, dtype=torch.float32, device=dev).view(h, 1)
    di = depth.to(torch.int32)
    d = di.to(torch.float32)
    px = d * (x - pp[0]) / f
    py = d * (y - pp[1]) / f
    m = _f32(mat, dev)
    z = ((m[2, 0] * px + m[2, 1] * py) + m[2, 2] * d) + m[2, 3]
    keep = (di > 0) & ~(z > -float(np.float32(threshold)))
    return torch.where(keep, di, 0).to(depth.dtype)


def gaussian_kernel(k_size: int, sigma: float) -> np.ndarray:
    """Host-side 2D gaussian weights, normalised to sum 1."""
    if k_size % 2 != 1:
        raise ValueError("kernel size must be odd")
    l = k_size // 2
    xs = np.linspace(-l, l, k_size)
    k1 = np.exp(-(xs ** 2) / (2.0 * sigma * sigma))
    k2 = np.outer(k1, k1)
    return (k2 / k2.sum()).astype(np.float32)


def gaussian_depth_filter(depth, kernel):
    """Missing-aware gaussian smoothing: in-bounds zero taps add their weight
    to w0, the others to wn and weight * depth to sn; taps outside the image
    are skipped; the output is 0 where w0 > wn, else floor(sn / wn).

    The k*k taps are summed explicitly in row-major order over a
    zero-padded image (no convolution, which cuDNN would run in TF32): the
    order the CUDA kernel uses, so the two agree bit for bit.
    depth (..., H, W); kernel (k, k) float32."""
    h, w = depth.shape[-2:]
    dev = depth.device
    kern = _f32(kernel, dev)
    k = kern.shape[0]
    half = k // 2
    d = depth.to(torch.float32)
    pad = (half, half, half, half)
    dpad = F.pad(d, pad)
    inb = F.pad(torch.ones_like(d, dtype=torch.bool), pad)
    sn = torch.zeros_like(d)
    wn = torch.zeros_like(d)
    w0 = torch.zeros_like(d)
    for dy in range(k):
        for dx in range(k):
            kv = kern[dy, dx]
            tap = dpad[..., dy:dy + h, dx:dx + w]
            nz = tap > 0
            zero = inb[..., dy:dy + h, dx:dx + w] & ~nz
            sn = torch.where(nz, sn + kv * tap, sn)
            wn = torch.where(nz, wn + kv, wn)
            w0 = torch.where(zero, w0 + kv, w0)
    mean = torch.floor(sn / torch.where(wn == 0, 1.0, wn))
    out = torch.where(w0 > wn, 0.0, mean)
    return out.to(torch.int32).to(depth.dtype)


def shrink_image(depth, mipmap_level: int):
    """Decimate by 2**level with point sampling."""
    f = 1 << mipmap_level
    return depth[..., ::f, ::f]


def grow_groups(g):
    """1-pixel 4-neighbour dilation of a group-stencil image: an empty pixel
    takes the first non-zero of its left, right, up, down neighbours."""
    h, w = g.shape[-2:]
    gi = g.to(torch.int32)
    p = F.pad(gi, (1, 1, 1, 1))
    candidates = [
        p[..., 1:h + 1, 0:w],        # left  (y, x - 1)
        p[..., 1:h + 1, 2:w + 2],    # right (y, x + 1)
        p[..., 0:h, 1:w + 1],        # up    (y - 1, x)
        p[..., 2:h + 2, 1:w + 1],    # down  (y + 1, x)
    ]
    out = gi
    filled = gi != 0
    for c in candidates:
        take = (~filled) & (c != 0)
        out = torch.where(take, c, out)
        filled = filled | take
    return out.to(g.dtype)


def stencil_depth_image_by_group(groups_small, depth, mipmap_level: int,
                                 group: int):
    """Full-res depth where the low-res group image == group, else 0."""
    f = 1 << mipmap_level
    g_full = groups_small.repeat_interleave(f, dim=-2).repeat_interleave(
        f, dim=-1)
    g_full = g_full[..., : depth.shape[-2], : depth.shape[-1]]
    return torch.where(g_full.to(torch.int32) == group,
                       depth.to(torch.int32), 0).to(depth.dtype)


def flip_x(img):
    """Mirror horizontally (uint16 through int32: PyTorch has no uint16
    flip)."""
    if img.dtype == torch.uint16:
        return torch.flip(img.to(torch.int32), dims=(-1,)).to(torch.uint16)
    return torch.flip(img, dims=(-1,))


def convert_0s_to_maxuint(depth):
    """0 -> 65535 sentinel."""
    di = depth.to(torch.int32)
    return torch.where(di == 0, MAX_UINT16, di).to(depth.dtype)


def make_rgba_from_labels(labels, colors):
    """Label id -> RGBA through the colour table (classes, 4) uint8; labels
    0 and 65535 stay transparent black."""
    l = labels.to(torch.int64)
    colors = torch.as_tensor(colors, dtype=torch.uint8, device=labels.device)
    valid = (l != 0) & (l != MAX_UINT16)
    idx = (l - 1).clamp(0, colors.shape[0] - 1)
    return torch.where(valid[..., None], colors[idx], 0).to(torch.uint8)
