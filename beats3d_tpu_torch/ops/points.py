"""Per-frame point and image ops in plain PyTorch (counterpart of
beats3d_tpu/ops/points.py).

Conventions: depth images are (H, W) or (N, H, W) integer tensors with
0 = missing and 65535 = "missing for the forest"; point clouds are (..., 4)
float32 with w == 1 marking a valid point.  Functions take uint16 (the JAX
package's dtype) or the int32 the pipeline carries, compute in int32 /
float32, and return images in their input's dtype.

Crops at origins that live on the device: :func:`crop` and :func:`place`
are the counterparts of the JAX package's ``crop_mm`` and ``scatter_mm``.
Those keep dynamic crops on the TPU's matrix unit as one-hot matmuls; here
they are index arithmetic and one ``gather`` each, bit-identical, with no
host read of the origins.

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


def depths_from_points(pts):
    """Point cloud -> depth image: z where w > 0, else 0.  z converts as
    the JAX package's float -> uint16 cast does on the CPU: truncated,
    saturated to [0, 65535], NaN -> 0, on every device.
    (..., 4) float32 -> (...) uint16."""
    z = torch.nan_to_num(pts[..., 2], nan=0.0).clamp(0.0, float(MAX_UINT16))
    z = z.to(torch.int32)
    return torch.where(pts[..., 3] > 0.0, z, 0).to(torch.uint16)


def transform_points(pts, mat):
    """Apply a 4x4 transform (new_p = M @ p) to the points with w == 1;
    the others pass through.  Each row is summed as
    (m0*p0 + m1*p1) + (m2*p2 + m3*p3), every product rounded to float32:
    the order of the JAX package's einsum on the CPU, and one that the
    card computes bit for bit alike (eager products and sums never fuse
    into a multiply-add)."""
    m = _f32(mat, pts.device)
    prod = pts[..., None, :] * m                     # (..., i, j) = m_ij p_j
    new = ((prod[..., 0] + prod[..., 1]) + (prod[..., 2] + prod[..., 3]))
    return torch.where(pts[..., 3:4] == 1.0, new, pts)


def remove_missing_3d_points_from_depth_image(pts, depth):
    """Zero depth where the point was filtered away (w == 0)."""
    return torch.where(pts[..., 3] == 0.0, 0, depth.to(torch.int32)).to(
        depth.dtype)


def setup_depth_image_for_forest(pts, depth):
    """Depth 0 or a filtered point -> 65535."""
    di = depth.to(torch.int32)
    missing = (di == 0) | (pts[..., 3] == 0.0)
    return torch.where(missing, MAX_UINT16, di).to(depth.dtype)


def filter_points_by_plane(pts, threshold):
    """Zero out plane-space points with w == 1 and z > -threshold (at or
    below the table band)."""
    t = float(np.float32(threshold))
    cut = (pts[..., 3] == 1.0) & (pts[..., 2] > -t)
    return torch.where(cut[..., None], 0.0, pts)


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
    *lead, hs, ws = groups_small.shape
    g_full = groups_small[..., :, None, :, None].expand(
        *lead, hs, f, ws, f).reshape(*lead, hs * f, ws * f)
    g_full = g_full[..., : depth.shape[-2], : depth.shape[-1]]
    return torch.where(g_full.to(torch.int32) == group,
                       depth.to(torch.int32), 0).to(depth.dtype)


def crop(img, oy, ox, ch: int, cw: int):
    """(ch, cw) windows of ``img`` (N, H, W) at origins ``oy``, ``ox`` (N,)
    integer tensors on its device: the counterpart of
    beats3d_tpu/ops/points.py:crop_mm.  Window pixels outside the image are
    0, as crop_mm's empty one-hot rows make them.  Returns (N, ch, cw) in
    the image's dtype."""
    n, h, w = img.shape
    dev = img.device
    ys = oy.to(torch.int64)[:, None] + torch.arange(ch, device=dev)
    xs = ox.to(torch.int64)[:, None] + torch.arange(cw, device=dev)
    inside = (((ys >= 0) & (ys < h))[:, :, None]
              & ((xs >= 0) & (xs < w))[:, None, :])
    lin = ys.clamp(0, h - 1)[:, :, None] * w + xs.clamp(0, w - 1)[:, None, :]
    out = torch.gather(img.reshape(n, h * w), 1, lin.reshape(n, -1))
    return torch.where(inside, out.reshape(n, ch, cw), 0).to(img.dtype)


def place(fill, img, oy, ox, hh: int, ww: int):
    """Each (ch, cw) image of ``img`` (N, ch, cw) on an (hh, ww) canvas of
    ``fill`` at origins ``oy``, ``ox`` (N,) integer tensors on its device:
    the counterpart of beats3d_tpu/ops/points.py:scatter_mm, the inverse of
    :func:`crop`.  Each canvas pixel gathers its image pixel; image pixels
    that fall outside the canvas are dropped, as in scatter_mm.  Returns
    (N, hh, ww) in the image's dtype."""
    n, ch, cw = img.shape
    dev = img.device
    ys = torch.arange(hh, device=dev) - oy.to(torch.int64)[:, None]
    xs = torch.arange(ww, device=dev) - ox.to(torch.int64)[:, None]
    inside = (((ys >= 0) & (ys < ch))[:, :, None]
              & ((xs >= 0) & (xs < cw))[:, None, :])
    lin = ys.clamp(0, ch - 1)[:, :, None] * cw + xs.clamp(0, cw - 1)[:, None, :]
    out = torch.gather(img.reshape(n, ch * cw), 1, lin.reshape(n, -1))
    return torch.where(inside, out.reshape(n, hh, ww), fill).to(img.dtype)


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


def write_pixel_groups_to_stencil_image(coords, num_coords, shape):
    """Scatter the first ``num_coords`` rows of an (M, 3) list of
    (y, x, gid) into a zeroed (H, W) uint16 stencil, the largest gid where
    rows meet (counterpart of beats3d_tpu/ops/points.py:
    write_pixel_groups_to_stencil_image).  As in JAX's scatter, a negative
    coordinate counts once from the end and a row outside the image is
    dropped."""
    h, w = shape
    c = torch.as_tensor(coords).to(torch.int64)
    valid = torch.arange(c.shape[0], device=c.device) < torch.as_tensor(
        num_coords, device=c.device)
    yy = torch.where(c[:, 0] < 0, c[:, 0] + h, c[:, 0])
    xx = torch.where(c[:, 1] < 0, c[:, 1] + w, c[:, 1])
    keep = valid & (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
    lin = torch.where(keep, yy * w + xx, 0)
    gid = torch.where(keep, c[:, 2], 0).to(torch.int32)
    out = torch.zeros(h * w, dtype=torch.int32, device=c.device)
    out.scatter_reduce_(0, lin, gid, reduce="amax")
    return out.reshape(h, w).to(torch.uint16)


def make_rgba_from_labels(labels, colors):
    """Label id -> RGBA through the colour table (classes, 4) uint8; labels
    0 and 65535 stay transparent black."""
    l = labels.to(torch.int64)
    colors = torch.as_tensor(colors, dtype=torch.uint8, device=labels.device)
    valid = (l != 0) & (l != MAX_UINT16)
    idx = (l - 1).clamp(0, colors.shape[0] - 1)
    return torch.where(valid[..., None], colors[idx], 0).to(torch.uint8)


def make_depth_rgba(depth, d_min, d_max):
    """Depth -> (..., H, W, 4) uint8 grayscale debug view with sentinel
    colours for missing (0), far (65535) and out-of-range depth
    (counterpart of beats3d_tpu/ops/points.py:make_depth_rgba).  The grey
    level floor(256 - (d - d_min) * 255 / (d_max - d_min)) is computed in
    float32 with an IEEE division and saturates into uint8 (NaN -> 0), as
    XLA converts it."""
    dev = depth.device
    di = depth.to(torch.int32)
    d = di.to(torch.float32)
    n_f = (d - _f32(d_min, dev)) * 255.0 / _f32(np.float32(d_max - d_min), dev)
    gray = torch.nan_to_num(torch.floor(256.0 - n_f), nan=0.0).clamp(0.0, 255.0)
    gray = gray.to(torch.uint8)
    out = torch.stack([gray, gray, gray, torch.full_like(gray, 255)], dim=-1)
    colour = lambda *c: torch.tensor(c, dtype=torch.uint8, device=dev)
    out = torch.where((di == 0)[..., None], colour(195, 157, 152, 255), out)
    out = torch.where((di == MAX_UINT16)[..., None],
                      colour(157, 195, 152, 255), out)
    in_mid = (di != 0) & (di != MAX_UINT16) & ((di < d_min) | (di > d_max))
    return torch.where(in_mid[..., None], colour(157, 152, 195, 255), out)
