# Copied from beats3d_tpu/data/rigged.py (numpy only).
"""Rigged skinned-hand generator — the framework's equivalent of the
reference's Blender/libhand asset (`datagen/Rigged Hand.blend`,
`datagen/libhand/` CC-BY hand model, readme.md:30-47).

No Blender exists on a TPU host, so the rig is procedural: a 21-bone
kinematic skeleton (wrist root, 4 three-phalanx fingers + metacarpals, an
OPPOSABLE two-phalanx thumb with its own flex plane) posed by forward
kinematics, and a surface sampled on each bone's capsule in REST pose then
deformed by linear blend skinning — every surface point carries weights to
the two bones adjacent to its nearest joint, so knuckles bend smoothly
instead of the point-primitive chains of :mod:`synth.hand_cloud` breaking
into disjoint capsules.  Output is the same contract as ``hand_cloud``
((P, 3) float32 points in hand units, (P, 3) uint8 paint colors), so
:func:`synth.splat_hand` / :func:`synth.articulated_scene` render it through
the splat z-buffer unchanged.

Distinct from ``hand_cloud`` (kept as the flagship training geometry so
committed datasets/goldens stay reproducible):

* a thumb that OPPOSES — its flex axis is rotated ~55 deg out of the finger
  plane, so full flex sweeps it across the palm, producing the
  thumb-under-finger occlusions real grasps have;
* skinned joints — blend-weighted vertices bridge each knuckle, so flexed
  fingers keep a closed surface (no inter-capsule gaps for the stereo-noise
  model's edge dropout to shred);
* anatomical proportions per digit (metacarpal arch, phalanx ratios
  ~0.58/0.36 of proximal) instead of one shared taper.

Opt-in via ``articulated_scene(rigged=True)`` / B3D_V2_RIGGED=1.
"""

from __future__ import annotations

import numpy as np

from .synth import FINGER_COLORS, PALM_COLOR

# Per-digit rig constants (hand units; palm radius ~95 at scale 1).
# Fingers: (base angle deg on palm rim, metacarpal len, proximal len,
# abduction range deg).  Thumb handled separately.
_FINGERS = [
    # index, middle, ring, pinky
    (62.0, 38.0, 56.0, 7.0),
    (84.0, 40.0, 62.0, 5.0),
    (106.0, 38.0, 56.0, 6.0),
    (128.0, 32.0, 42.0, 9.0),
]
_PHALANX_RATIOS = (1.0, 0.58, 0.36)  # proximal : middle : distal
_FINGER_RADII = (13.0, 11.0, 9.0)


def _rot_axis(axis, a):
    """3x3 rotation of angle ``a`` about unit ``axis`` (Rodrigues)."""
    axis = np.asarray(axis, np.float64)
    axis = axis / np.linalg.norm(axis)
    k = np.array([
        [0, -axis[2], axis[1]],
        [axis[2], 0, -axis[0]],
        [-axis[1], axis[0], 0],
    ])
    return (np.eye(3) + np.sin(a) * k + (1 - np.cos(a)) * (k @ k)).astype(
        np.float64)


class _Bone:
    """One rig bone: rest head/tail + world transform after FK."""

    __slots__ = ("head", "tail", "radius", "color", "rot", "trans")

    def __init__(self, head, tail, radius, color):
        self.head = np.asarray(head, np.float64)
        self.tail = np.asarray(tail, np.float64)
        self.radius = float(radius)
        self.color = color
        self.rot = np.eye(3)
        self.trans = np.zeros(3)

    def world(self, p):
        """Apply this bone's posed transform to rest-space points (N, 3)."""
        return (p - self.head) @ self.rot.T + self.head + self.trans


def _digit_chain(base, direction, lengths, radii, color):
    """Rest-pose bone chain from ``base`` along unit ``direction``."""
    bones = []
    pos = np.asarray(base, np.float64)
    d = np.asarray(direction, np.float64)
    d = d / np.linalg.norm(d)
    for ln, r in zip(lengths, radii):
        bones.append(_Bone(pos, pos + d * ln, r, color))
        pos = pos + d * ln
    return bones


def _pose_chain(bones, flex_axis, angles, abduct_axis=None, abduct=0.0):
    """FK: rotate each bone about ``flex_axis`` at its head by its angle,
    composing down the chain (plus optional abduction at the first joint)."""
    rot = np.eye(3)
    if abduct_axis is not None and abduct != 0.0:
        rot = _rot_axis(abduct_axis, abduct)
    pivot_rest = bones[0].head
    pivot_world = bones[0].head.copy()
    for bone, ang in zip(bones, angles):
        # world position of this bone's head under the accumulated pose
        head_w = (bone.head - pivot_rest) @ rot.T + pivot_world
        rot = rot @ _rot_axis(flex_axis, ang)
        bone.rot = rot
        bone.trans = head_w - bone.head
        pivot_rest = bone.head
        pivot_world = head_w


def _sample_capsule(rng, bone, density, upper_only=True):
    """Rest-pose surface samples on a bone capsule: (pts, t param)."""
    d = bone.tail - bone.head
    ln = np.linalg.norm(d)
    d = d / ln
    # orthonormal frame around the bone axis
    up = np.array([0.0, 0.0, 1.0])
    side = np.cross(d, up)
    if np.linalg.norm(side) < 1e-6:
        side = np.array([1.0, 0.0, 0.0])
    side = side / np.linalg.norm(side)
    up2 = np.cross(side, d)
    n = max(8, int(density * ln * bone.radius))
    t = rng.uniform(-0.08, 1.08, n)
    ring = rng.uniform(0, np.pi if upper_only else 2 * np.pi, n)
    pts = (
        bone.head[None, :]
        + np.clip(t, 0, 1)[:, None] * d[None, :] * ln
        + (np.cos(ring)[:, None] * side[None, :]
           + np.sin(ring)[:, None] * up2[None, :]) * bone.radius
    )
    return pts, t


def rigged_hand_cloud(rng, flex_scale=1.0, detail=0.0):
    """One posed skinned RIGHT hand; same output contract as
    :func:`synth.hand_cloud` ((P, 3) f32 hand-unit points, (P, 3) u8 colors).

    Pose: per-digit MCP abduction + 3 flex angles (2 for the thumb), drawn
    from ``rng`` scaled by ``flex_scale``; the thumb's flex plane is rotated
    toward the palm so flex >= ~0.6 crosses it (opposition).
    """
    scale = rng.uniform(0.68, 0.98)
    palm_r = 95.0 * scale
    pts_all, col_all = [], []

    # ---- palm + forearm (root bone: identity transform) -----------------
    oval = rng.uniform(0.88, 1.0)
    n_p = int(1.4 * np.pi * palm_r * palm_r * oval)
    rr = palm_r * np.sqrt(rng.uniform(0, 1, n_p))
    th = rng.uniform(0, 2 * np.pi, n_p)
    px = rr * np.cos(th)
    py = rr * np.sin(th) * oval
    # metacarpal arch: the palm domes higher over the knuckle line
    pz = 14.0 * scale * np.cos(np.clip(rr / palm_r, 0, 1) * np.pi / 2) \
        + 4.0 * scale * np.clip(py / palm_r, 0, 1)
    if detail > 0:
        drng = np.random.default_rng(np.uint64(scale * 1e9))
        for ph, fr in ((drng.uniform(0, np.pi), 2.2),
                       (drng.uniform(0, np.pi), 3.1)):
            pz = pz - detail * scale * np.exp(
                -((np.sin(fr * th + ph) * rr / palm_r) ** 2) * 18.0)
    pts_all.append(np.stack([px, py, pz], 1))
    col_all.append(np.tile(np.array(PALM_COLOR, np.uint8), (n_p, 1)))

    arm_w, arm_l = 1.1 * palm_r, 70.0 * scale
    n_a = int(1.4 * arm_w * arm_l)
    pts_all.append(np.stack([
        rng.uniform(-0.5, 0.5, n_a) * arm_w,
        -palm_r * 0.8 - rng.uniform(0, 1, n_a) * arm_l,
        np.full(n_a, 8.0 * scale)], 1))
    col_all.append(np.tile(np.array(PALM_COLOR, np.uint8), (n_a, 1)))

    density = 1.6 * 2.2

    def skin_chain(bones, ts_blend=0.18):
        """Sample every bone, LBS-blend each sample between its own bone and
        its parent across the joint (t < ts_blend ramps parent weight)."""
        for bi, bone in enumerate(bones):
            rest, t = _sample_capsule(rng, bone, density)
            if detail > 0:
                tt = np.clip(t, 0, 1)
                rest = rest + np.stack([
                    np.zeros_like(tt), np.zeros_like(tt),
                    detail * scale * np.exp(-((tt - 0.08) ** 2) * 120.0),
                ], 1)
            posed_self = bone.world(rest)
            if bi == 0:
                # parent is the (rigid, identity-posed) palm
                w = np.clip(t / ts_blend, 0, 1)[:, None]
                posed = w * posed_self + (1 - w) * rest
            else:
                posed_par = bones[bi - 1].world(rest)
                w = np.clip(t / ts_blend, 0, 1)[:, None]
                posed = w * posed_self + (1 - w) * posed_par
            pts_all.append(posed)
            col_all.append(np.tile(
                np.array(bone.color, np.uint8), (posed.shape[0], 1)))

    # ---- four fingers ----------------------------------------------------
    for k, (ang_deg, mc_len, prox_len, abd_range) in enumerate(_FINGERS):
        ang = np.deg2rad(ang_deg) + rng.uniform(-0.06, 0.06)
        dir2 = np.array([np.cos(ang), np.sin(ang), 0.0])
        base = dir2 * palm_r * 0.55 + np.array([0, 0, 12.0 * scale])
        lengths = np.array([mc_len] + [
            prox_len * r for r in _PHALANX_RATIOS]) * scale
        radii = [12.0 * scale] + [r * scale for r in _FINGER_RADII]
        bones = _digit_chain(
            base, dir2, lengths, radii, FINGER_COLORS[k + 1])
        flex = rng.uniform(0.0, 1.0) * flex_scale
        flex_axis = np.array([-dir2[1], dir2[0], 0.0])  # bend out of plane
        angles = np.deg2rad([
            0.0,  # metacarpal: rigid in the palm
            rng.uniform(-8, 20) + 62 * flex,
            rng.uniform(0, 16) + 46 * flex,
            rng.uniform(0, 10) + 28 * flex,
        ])
        abduct = np.deg2rad(rng.uniform(-abd_range, abd_range))
        _pose_chain(bones, flex_axis, angles,
                    abduct_axis=np.array([0.0, 0.0, 1.0]), abduct=abduct)
        skin_chain(bones[1:])  # metacarpal is palm interior: not sampled

    # ---- opposable thumb -------------------------------------------------
    t_ang = np.deg2rad(18.0) + rng.uniform(-0.08, 0.08)
    t_dir = np.array([np.cos(t_ang), np.sin(t_ang), 0.0])
    t_base = t_dir * palm_r * 0.45 + np.array([0, 0, 10.0 * scale])
    t_lengths = np.array([34.0, 42.0, 30.0]) * scale
    t_radii = [15.0 * scale, 13.5 * scale, 11.0 * scale]
    bones = _digit_chain(t_base, t_dir, t_lengths, t_radii, FINGER_COLORS[0])
    flex = rng.uniform(0.0, 1.0) * flex_scale
    # Opposition: flex axis tilted ~55 deg toward the palm normal, so flex
    # sweeps the thumb ACROSS the palm surface, not just out of plane.
    in_plane = np.array([-t_dir[1], t_dir[0], 0.0])
    opp = np.deg2rad(55.0)
    t_axis = _rot_axis(t_dir, opp) @ in_plane
    angles = np.deg2rad([
        rng.uniform(0, 14) + 38 * flex,
        rng.uniform(0, 10) + 42 * flex,
        rng.uniform(0, 8) + 30 * flex,
    ])
    _pose_chain(bones, t_axis, angles,
                abduct_axis=np.array([0.0, 0.0, 1.0]),
                abduct=np.deg2rad(rng.uniform(-14, 4)))
    skin_chain(bones)

    return (np.concatenate(pts_all).astype(np.float32),
            np.concatenate(col_all))
