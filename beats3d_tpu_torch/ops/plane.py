"""RANSAC table-plane calibration (counterpart of beats3d_tpu/ops/plane.py).

Candidate planes are built from random triples of valid points; each is a
rigid camera->plane transform whose rows are an orthonormal basis with z =
the triple's normal, so plane-space |z| is the distance to the candidate
plane.  The candidate with the most points within |z| < threshold wins
(the first of equal counts), and is re-centred so the camera's forward ray
hits the plane-space origin in (x, y).

Candidates are built from a (num_candidates, 32) tensor of uniforms in
[0, 1): :class:`CalibratedPlane` draws it with a ``torch.Generator``, and
tests hand the same numpy uniforms to this module and to the JAX package.
Every product with point coordinates (up to 65535) stays in full float32.
"""

from __future__ import annotations

from typing import Optional

import torch

CHUNK = 512


def _norm(v):
    """v / |v| through rsqrt plus one Newton step, as the JAX package does
    (its TPU rsqrt is approximate; the step keeps the two in agreement)."""
    s = (v * v).sum(dim=-1, keepdim=True)
    r = torch.rsqrt(s)
    r = r * (1.5 - 0.5 * s * r * r)
    return v * r


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
    z_axis = _norm(torch.linalg.cross(v0, v1, dim=-1))
    # The camera (origin) lands on the negative-z side of the plane, so hands
    # above the table survive the z <= -threshold band.
    dot = (z_axis[:, 0] * p0[:, 0] + z_axis[:, 1] * p0[:, 1]) + z_axis[:, 2] * p0[:, 2]
    flip = torch.where(dot < 0.0, -1.0, 1.0)[:, None]
    z_axis = z_axis * flip
    x_axis = v0
    y_axis = _norm(torch.linalg.cross(z_axis, x_axis, dim=-1))
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
    """Inliers per candidate: points with w == 1 and |plane z| < threshold.
    One (points x chunk) full-float32 product per chunk of candidates."""
    pts_flat = pts.reshape(-1, 4)
    valid = pts_flat[:, 3] == 1.0
    xyz = pts_flat[:, :3]
    zrow = candidates[:, 2, :]
    counts = []
    for c0 in range(0, zrow.shape[0], chunk):
        zr = zrow[c0:c0 + chunk]
        z = torch.matmul(xyz, zr[:, :3].T) + zr[:, 3][None, :]
        inl = (z.abs() < threshold) & valid[:, None]
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


class CalibratedPlane:
    """Holds the current plane matrix and the candidate random stream."""

    def __init__(self, num_random_guesses: int = 25000,
                 plane_z_outlier_threshold: float = 40.0, seed: int = 0,
                 device="cuda"):
        self.num_random_guesses = num_random_guesses
        self.plane_z_outlier_threshold = plane_z_outlier_threshold
        self.device = torch.device(device)
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self.plane = None

    def is_set(self) -> bool:
        return self.plane is not None

    def get_mat(self):
        if self.plane is None:
            raise RuntimeError("the plane is not calibrated yet")
        return self.plane

    def make(self, pts, start_mat=None):
        uniforms = torch.rand(
            (self.num_random_guesses, 32), generator=self._gen,
            device=self.device, dtype=torch.float32,
        )
        self.plane = calibrate_plane(
            uniforms, pts, float(self.plane_z_outlier_threshold),
            start_mat=start_mat,
        )
        return self.plane
