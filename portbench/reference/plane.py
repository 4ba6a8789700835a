"""RANSAC table-plane calibration: the benchmark's reference for the plane
that ``BeatsApp`` calibrates at its first tick, recomputed from the same
uniforms (a frozen copy of beats3d_tpu_torch/ops/plane.py).

Candidate planes come from random triples of valid points; the candidate
with the most points within |z| < threshold wins (the first of equal
counts) and is re-centred so the camera's forward ray hits the plane-space
origin.  Every operation rounds as IEEE float32 does, so the card and the
CPU build the same candidates.  Imports nothing of the program.
"""

from __future__ import annotations

from typing import Optional

import torch

CHUNK = 512


def _norm(v):
    """v / |v| through 1 / sqrt plus one Newton step, as the JAX package
    does with its rsqrt (approximate on the TPU; the step keeps the two in
    agreement).  Every operation rounds as IEEE float32 does, so the card
    and the CPU build the same candidates: the square root and the
    reciprocal are taken in float64 and rounded once to float32, which
    gives the correctly rounded float32 results (53 >= 2 * 24 + 2 bits);
    PyTorch's float32 sqrt is not correctly rounded, on the card or on
    the CPU."""
    s = (v[..., 0:1] * v[..., 0:1] + v[..., 1:2] * v[..., 1:2]) \
        + v[..., 2:3] * v[..., 2:3]
    root = torch.sqrt(s.to(torch.float64)).to(torch.float32).to(torch.float64)
    r = (torch.ones_like(root) / root).to(torch.float32)
    r = r * (1.5 - 0.5 * s * r * r)
    return v * r


def _cross(a, b):
    """a x b over the last dimension, products and differences rounded one
    by one (``torch.linalg.cross`` may fuse them on one device and not on
    the other)."""
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=-1)


def make_plane_candidates(uniforms, pts):
    """(num_candidates, 4, 4) camera->plane candidates from a
    (num_candidates, 32) uniform tensor and a (..., 4) point cloud: per row,
    the first 3 of the 32 drawn points with z > 0 span the plane."""
    pts_flat = pts.reshape(-1, 4)
    num_px = pts_flat.shape[0]
    dev = pts.device
    idx = torch.floor(uniforms.to(torch.float32) * num_px).to(torch.int64)
    idx = idx.clamp(0, num_px - 1)
    cand = pts_flat[idx]                                  # (N, 32, 4)
    valid = cand[..., 2] > 0.0
    order = torch.cumsum(valid.to(torch.int32), dim=1)

    def pick(k):
        hit = valid & (order == k)
        first = torch.argmax(hit.to(torch.int32), dim=1)  # first True
        p = torch.gather(cand[..., :3], 1, first.view(-1, 1, 1).expand(-1, 1, 3))
        return p[:, 0], hit.any(dim=1)

    p0, ok0 = pick(1)
    p1, ok1 = pick(2)
    p2, ok2 = pick(3)
    ok = ok0 & ok1 & ok2

    v0 = _norm(p1 - p0)
    v1 = _norm(p2 - p0)
    z_axis = _norm(_cross(v0, v1))
    # The camera (origin) lands on the negative-z side of the plane, so hands
    # above the table survive the z <= -threshold band.
    dot = (z_axis[:, 0] * p0[:, 0] + z_axis[:, 1] * p0[:, 1]) + z_axis[:, 2] * p0[:, 2]
    flip = torch.where(dot < 0.0, -1.0, 1.0)[:, None]
    z_axis = z_axis * flip
    x_axis = v0
    y_axis = _norm(_cross(z_axis, x_axis))
    rot = torch.stack([x_axis, y_axis, z_axis], dim=1)   # (N, 3, 3) rows = axes
    t = -((rot[..., 0] * p0[:, None, 0] + rot[..., 1] * p0[:, None, 1])
          + rot[..., 2] * p0[:, None, 2])
    top = torch.cat([rot, t[..., None]], dim=2)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], device=dev).expand(
        top.shape[0], 1, 4)
    mat = torch.cat([top, bottom], dim=1)
    # Degenerate candidates (fewer than 3 valid points, collinear triples)
    # score zero inliers: the z-row translation is parked at 1e30.
    degenerate = ~ok | ~torch.isfinite(mat).all(dim=(1, 2))
    dead = torch.zeros((4, 4), dtype=torch.float32, device=dev)
    dead[2, 3] = 1e30
    return torch.where(degenerate[:, None, None], dead, mat)


def count_inliers(pts, candidates, threshold, chunk: int = CHUNK):
    """Inliers per candidate: points with w == 1 and |plane z| < threshold,
    over (points x chunk) candidates at a time.  z = fma(z, m2, fma(y, m1,
    x*m0)) + m3, each multiply-add rounded once to float32 (emulated in
    float64, where the products are exact): the JAX package's dot on the
    CPU computes exactly this, and elementwise the card counts what the
    CPU counts (a matrix product's summation order is the library's)."""
    pts_flat = pts.reshape(-1, 4)
    valid = pts_flat[:, 3] == 1.0
    x = pts_flat[:, 0:1]
    y, z = (pts_flat[:, i:i + 1].to(torch.float64) for i in (1, 2))
    zrow = candidates[:, 2, :]
    counts = []
    for c0 in range(0, zrow.shape[0], chunk):
        m = zrow[c0:c0 + chunk]
        m64 = m.to(torch.float64)
        pz = x * m[:, 0]
        pz = (y * m64[:, 1] + pz.to(torch.float64)).to(torch.float32)
        pz = (z * m64[:, 2] + pz.to(torch.float64)).to(torch.float32)
        pz = pz + m[:, 3]
        inl = (pz.abs() < threshold) & valid[:, None]
        counts.append(inl.sum(dim=0))
    return torch.cat(counts)


def _recenter(mat):
    """Translate the plane transform so the camera's forward ray hits the
    plane-space origin."""
    t = -mat[2, 3] / mat[2, 2]  # depth at which the (0, 0, 1) ray meets it
    c = mat[:, 2] * t + mat[:, 3]
    shift = torch.eye(4, dtype=torch.float32, device=mat.device)
    shift[0, 3] = -c[0]
    shift[1, 3] = -c[1]
    return torch.matmul(shift, mat)


def calibrate_plane(uniforms, pts, threshold,
                    start_mat: Optional[torch.Tensor] = None):
    """Propose, score, pick the best, re-centre.  ``start_mat`` seeds
    candidate 0 with a previous plane so recalibration can only improve.
    Returns the re-centred (4, 4) float32 camera->plane matrix."""
    candidates = make_plane_candidates(uniforms, pts)
    if start_mat is not None:
        candidates[0] = start_mat.to(candidates)
    counts = count_inliers(pts, candidates, threshold)
    best = torch.argmax(counts)
    return _recenter(candidates[best])


def draw_uniforms(num_candidates: int, seed: int, device):
    """The (num_candidates, 32) uniforms the program's calibrated plane
    draws first: ``torch.rand`` from a ``torch.Generator`` on ``device``
    seeded with ``seed``."""
    gen = torch.Generator(device=torch.device(device)).manual_seed(seed)
    return torch.rand((num_candidates, 32), generator=gen,
                      device=torch.device(device), dtype=torch.float32)
