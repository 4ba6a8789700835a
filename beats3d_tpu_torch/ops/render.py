"""Depth/colour re-rendering and the render-and-compare cost in plain
PyTorch (counterpart of beats3d_tpu/ops/render.py).

Each source point is splatted into its rounded projected pixel through a
z-buffer: the nearest integer z wins and exact z ties go to the lowest
source index.  Both are ``scatter_reduce_(..., "amin")`` passes on int32,
and a minimum does not depend on the order of the updates, so the card
renders the same bits as the CPU.  Small holes are then closed by a
neighbour-min fill.

``round`` is half to even here as in XLA, divisions are tensor / tensor
(CUDA turns a division by a Python scalar into a product with the
reciprocal), and float -> int casts saturate as XLA's do.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

MAX_UINT16 = 65535
_INT32_MAX = 2 ** 31 - 1


def _f32(v, device):
    return torch.as_tensor(v, dtype=torch.float32, device=device)


def _saturating_int32(x):
    """float32 -> int32 as XLA casts on the CPU: truncated toward zero,
    saturated at the int32 range, NaN -> 0 (torch's own cast leaves
    out-of-range values undefined)."""
    x = torch.nan_to_num(x, nan=0.0)
    hi = x >= 2.0 ** 31
    # 2147483520 is the largest float32 below 2**31
    v = x.clamp(-(2.0 ** 31), 2147483520.0).to(torch.int32)
    return torch.where(hi, _INT32_MAX, v)


def project_points(pts, pp, focal):
    """Camera-space float4 points -> integer pixel coordinates and
    validity: u = round(f*x/z + ppx), v = round(f*y/z + ppy); points with
    w != 1 or z <= 0 are invalid."""
    dev = pts.device
    pp = _f32(pp, dev)
    f = _f32(focal, dev)
    x, y, z, w = pts[..., 0], pts[..., 1], pts[..., 2], pts[..., 3]
    valid = (w == 1.0) & (z > 0.0)
    zs = torch.where(z <= 0, 1.0, z)
    u = _saturating_int32(torch.round(f * x / zs + pp[0]))
    v = _saturating_int32(torch.round(f * y / zs + pp[1]))
    return u, v, valid


def zbuffer(pts_flat, pp, focal, h: int, w: int):
    """The z-buffer of (P, 4) points on an (h, w) image: (zbuf (h*w + 1,)
    int32 with 65535 where nothing landed and slot h*w the dump of the
    points off the image, tgt (P,) int64 target slots, zi (P,) int32 point
    depths, inb (P,) bool)."""
    n = h * w
    u, v, valid = project_points(pts_flat, pp, focal)
    inb = valid & (u >= 0) & (u < w) & (v >= 0) & (v < h)
    tgt = torch.where(inb, v.to(torch.int64) * w + u, n)
    zi = pts_flat[:, 2].clamp(0, MAX_UINT16 - 1).to(torch.int32)
    zbuf = torch.full((n + 1,), MAX_UINT16, dtype=torch.int32,
                      device=pts_flat.device)
    zbuf.scatter_reduce_(0, tgt, torch.where(inb, zi, MAX_UINT16), "amin")
    return zbuf, tgt, zi, inb


def splat_points(pts, colors, pp, focal):
    """(depth uint16, colour uint8) images from an (H, W, 4) float32 point
    cloud (w == 1 valid) and its (H, W, 3) uint8 colours, the same (H, W)
    as the cloud."""
    h, w = pts.shape[:2]
    n = h * w
    dev = pts.device
    zbuf, tgt, zi, inb = zbuffer(pts.reshape(-1, 4), pp, focal, h, w)
    # the winner per target: among the sources at the z-buffer's depth,
    # the lowest index
    src = torch.arange(n, dtype=torch.int32, device=dev)
    won = inb & (zi == zbuf[tgt])
    winner = torch.full((n + 1,), n, dtype=torch.int32, device=dev)
    winner.scatter_reduce_(0, tgt, torch.where(won, src, n), "amin")
    has = zbuf[:n] != MAX_UINT16
    depth = torch.where(has, zbuf[:n], 0).to(torch.uint16).reshape(h, w)
    cols = torch.cat([colors.reshape(-1, 3),
                      torch.zeros((1, 3), dtype=colors.dtype, device=dev)])
    color = torch.where(has[:, None], cols[winner[:n].to(torch.int64)],
                        0).to(torch.uint8).reshape(h, w, 3)
    return depth, color


def fill_holes(depth, color):
    """Close 1-pixel rendering holes: a zero-depth pixel with >= 3 of its 4
    neighbours populated takes the neighbour min depth and that
    neighbour's colour (the first of up, down, left, right on ties)."""
    h, w = depth.shape
    d = depth.to(torch.int32)
    dn = torch.where(d == 0, MAX_UINT16, d)
    pad = F.pad(dn, (1, 1, 1, 1), value=MAX_UINT16)
    shifts = [pad[:-2, 1:-1], pad[2:, 1:-1], pad[1:-1, :-2], pad[1:-1, 2:]]
    cpad = F.pad(color.permute(2, 0, 1), (1, 1, 1, 1)).permute(1, 2, 0)
    cshifts = [cpad[:-2, 1:-1], cpad[2:, 1:-1], cpad[1:-1, :-2],
               cpad[1:-1, 2:]]
    present = sum((s != MAX_UINT16).to(torch.int32) for s in shifts)
    nmin, cmin = shifts[0], cshifts[0]
    for s, cs in zip(shifts[1:], cshifts[1:]):
        take = s < nmin
        cmin = torch.where(take[..., None], cs, cmin)
        nmin = torch.where(take, s, nmin)
    fill = (d == 0) & (present >= 3)
    out_d = torch.where(fill, nmin, d)
    out_d = torch.where(out_d == MAX_UINT16, 0, out_d).to(torch.uint16)
    out_c = torch.where(fill[..., None], cmin, color)
    return out_d, out_c


def calc_image_cost(d0, d1, labels, target_label: int):
    """Render-and-compare cost: a boundary mismatch (target pixel not
    rendered, or a rendered pixel off the target) costs 100, a rendered
    target pixel 0.01 * (depth difference)^2; pixels missing in the
    observed d0 are free.  Returns a float32 scalar tensor.

    The boundary term is an integer count times 100 (exact); the overlap
    terms are float32 and summed in float64, then rounded to float32, so
    the card and the CPU give the same cost (a float32 sum would depend on
    the reduction order)."""
    d0i = d0.to(torch.int32)
    d1i = d1.to(torch.int32)
    observed = d0i != 0
    is_target = labels.to(torch.int32) == int(target_label)
    boundary = ((is_target & (d1i == 0)) | (~is_target & (d1i != 0))) \
        & observed
    overlap = is_target & (d1i != 0) & observed & ~boundary
    diff = (d0i.to(torch.float32) - d1i.to(torch.float32)).abs()
    terms = torch.where(overlap, 0.01 * diff * diff, 0.0)
    n_boundary = boundary.sum(dtype=torch.int64)
    over = terms.to(torch.float64).sum().to(torch.float32)
    return (n_boundary.to(torch.float32) * 100.0) + over
