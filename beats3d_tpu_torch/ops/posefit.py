"""Render-and-compare pose fitting in PyTorch (counterpart of
beats3d_tpu/ops/posefit.py): fit a cylinder to a labelled region by random
search over its pose, minimising the depth-image cost of
:func:`..ops.render.calc_image_cost`.

The cylinder's surface is point-sampled and splatted through the z-buffer
of :mod:`..ops.render` on ``device``; the search itself (the numpy
``Generator``'s draws, the accept test on each cost as a Python float) runs
on the host as in the JAX package.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..utils import transforms as tf
from . import points, render

MAX_UINT16 = 65535


@dataclasses.dataclass
class CylinderTform:
    """Translate/rotate/scale pose of a unit cylinder."""

    t: np.ndarray = None
    r: np.ndarray = None
    s: np.ndarray = None

    def __post_init__(self):
        self.t = np.zeros(3, np.float32) if self.t is None else self.t
        self.r = np.zeros(3, np.float32) if self.r is None else self.r
        self.s = np.zeros(3, np.float32) if self.s is None else self.s

    def get_tform(self) -> np.ndarray:
        return (
            tf.translate(self.t)
            @ tf.rotate_z(self.r[2])
            @ tf.rotate_x(np.pi / 2 + self.r[0])
            @ tf.scale(self.s)
        )

    def copy(self) -> "CylinderTform":
        return CylinderTform(self.t.copy(), self.r.copy(), self.s.copy())

    def make_random(self, rng: np.random.Generator) -> "CylinderTform":
        """Perturb one of translate / rotate / scale."""
        n = self.copy()
        a = rng.integers(3)
        if a == 0:
            b = rng.integers(3)
            n.t[b] = rng.normal(n.t[b], 25.0)
        elif a == 1:
            b = rng.choice([0, 2])
            n.r[b] = rng.normal(n.r[b], 0.1)
        else:
            b = rng.normal(n.s[0], 5.0)
            n.s[0] = b * 1.3
            n.s[1] = b
        return n


def cylinder_surface(n_theta: int = 96, n_len: int = 96) -> np.ndarray:
    """Point samples of a unit cylinder: radius 1 in xy, length 1 along +y
    before the rotate_x(pi/2) in get_tform stands it along plane-z.
    Returns (n_theta * n_len, 4) float32 homogeneous points."""
    theta = np.linspace(0, 2 * np.pi, n_theta, endpoint=False)
    l = np.linspace(0.0, 1.0, n_len)
    tt, ll = np.meshgrid(theta, l)
    pts = np.stack(
        [np.cos(tt), np.sin(tt), ll, np.ones_like(tt)], axis=-1
    ).reshape(-1, 4)
    return pts.astype(np.float32)


def render_cylinder_depth(surface, obj_tform, pp, focal, shape):
    """Transform the (P, 4) unit-cylinder samples by the (4, 4) object
    transform into camera space and splat a depth image of ``shape``
    (H, W): uint16, 0 where nothing landed.  The transform sums each row
    in the JAX package's order (C-w11, :func:`..ops.points.transform_points`)."""
    h, w = shape
    cam = points.transform_points(surface, obj_tform)
    cam = torch.cat([cam[:, :3], torch.ones_like(cam[:, 3:])], dim=1)
    zbuf = render.zbuffer(cam, pp, focal, h, w)[0][: h * w]
    d = torch.where(zbuf != MAX_UINT16, zbuf, 0)
    return d.to(torch.uint16).reshape(h, w)


def fit_cylinder(
    observed_depth,
    labels,
    plane_mat: np.ndarray,
    init: CylinderTform,
    pp,
    focal,
    *,
    target_label: int = 1,
    iterations: int = 200,
    rng: np.random.Generator = None,
    n_samples: int = 96,
    log=None,
    on_improve=None,
    device="cuda",
):
    """Random-search pose fit on ``device``.  Returns (best_tform,
    best_cost, history of the best cost after each iteration).

    ``on_improve(iteration, cost, tform)`` fires for the initial pose and
    every accepted improvement."""
    rng = rng or np.random.default_rng()
    surface = torch.as_tensor(cylinder_surface(n_samples, n_samples),
                              device=device)
    inv_plane = np.linalg.inv(plane_mat.astype(np.float64)).astype(np.float32)
    obs = torch.as_tensor(observed_depth, device=device).to(torch.int32)
    lab = torch.as_tensor(labels, device=device).to(torch.int32)
    shape = tuple(obs.shape)

    def cost_of(tform: CylinderTform) -> float:
        obj = inv_plane @ tform.get_tform()
        d1 = render_cylinder_depth(surface, obj, pp, focal, shape)
        return float(render.calc_image_cost(obs, d1, lab, target_label))

    best = init
    best_cost = cost_of(init)
    history = [best_cost]
    if on_improve:
        on_improve(0, best_cost, best.copy())
    for i in range(iterations):
        cand = best.make_random(rng)
        c = cost_of(cand)
        if c < best_cost:
            best, best_cost = cand, c
            if log:
                log(f"better cost: {best_cost:.1f}")
            if on_improve:
                on_improve(i + 1, best_cost, best.copy())
        history.append(best_cost)
    return best, best_cost, history
