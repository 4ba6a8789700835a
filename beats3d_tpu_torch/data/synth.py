# Copied from beats3d_tpu/data/synth.py (the rigged=False path); the splat
# renderer it calls is re-implemented in numpy below.
"""Articulated synthetic hand scenes — the framework's test/bench geometry.

The reference's training data is skin-paint-labeled articulated hands
captured live (src/live_data_convert.py) or posed libhand renders
(datagen/libhand, readme.md:30-47).  Neither camera nor Blender exists on a
TPU host, so this module builds an articulated hand — palm disk + forearm +
five 3-segment jointed fingers — as a camera-space point cloud and renders
it through the framework's own splat z-buffer renderer (ops/render.py), the
same path datagen re-renders augmented frames with.  Joint flex folds
fingers over the palm and the z-buffer resolves the occlusion, so generated
scenes carry the depth discontinuities and self-occlusion structure the
reference's operating point has, not separable rigid blobs.

Used by scripts/flagship_v2.py (training data), bench.py (bench scenes),
and available to apps as a hardware-free source.
"""

from __future__ import annotations

import numpy as np

MAX_UINT16 = 65535

FINGER_COLORS = [
    (220, 40, 40), (40, 220, 40), (40, 40, 220),
    (220, 220, 40), (220, 40, 220),
]
PALM_COLOR = (210, 160, 120)


def part_labels(color):
    """Class ids of a rendered colour image (H, W, 3) uint8: the palm (and
    forearm) colour -> 1, finger k's colour -> 2 + k, anything else -> 0.
    Returns (H, W) uint16; seven classes in all."""
    labels = np.zeros(color.shape[:2], np.uint16)
    for class_id, rgb in enumerate([PALM_COLOR] + FINGER_COLORS, start=1):
        labels[np.all(color == np.array(rgb, np.uint8), axis=-1)] = class_id
    return labels


def _rot2(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, -s], [s, c]], np.float32)


def hand_cloud(rng, flex_scale=1.0, detail=0.0):
    """One articulated RIGHT hand as (P, 3) float32 points in PIXEL
    units (1 unit projects to ~1 pixel at table depth; +y toward the
    fingers, z = height above the palm plane) + (P, 3) uint8 paint colors.

    ``detail`` > 0 adds surface relief (knuckle ridges along finger
    segments, palm crease furrows) of that amplitude in hand units —
    the realism knob for training data (clean geometry stays the default
    so committed goldens remain valid).

    Palm: dense disk (upper surface) with a shallow dome + a forearm stub.
    Fingers: 3-segment capsule chains; per-joint flex angles are random up
    to ``flex_scale`` — flexed chains fold OVER the palm (the caller's
    z-buffer occludes palm points underneath).  Density ~1.4 points/px so
    the splat is hole-free after fill_holes.
    """
    # sized so hand + forearm + extended fingers stay inside the pipeline's
    # 448x512 crop window at max scale INCLUDING the ~1.18x perspective
    # magnification of a hand ~400 units closer than the table
    scale = rng.uniform(0.68, 0.98)
    palm_r = 95.0 * scale
    pts, cols = [], []

    oval = rng.uniform(0.88, 1.0)
    n_p = int(1.4 * np.pi * palm_r * palm_r * oval)
    rr = palm_r * np.sqrt(rng.uniform(0, 1, n_p))
    th = rng.uniform(0, 2 * np.pi, n_p)
    px = rr * np.cos(th)
    py = rr * np.sin(th) * oval
    pz = 14.0 * scale * np.cos(np.clip(rr / palm_r, 0, 1) * np.pi / 2)
    if detail > 0:
        # palm crease furrows: two shallow arcs across the palm.  Phases
        # come from a fork seeded by this hand's own scale draw, NOT from
        # ``rng`` — the pose stream stays identical for any ``detail``
        # setting (same seed -> same hand, with/without relief), keeping
        # bench scenes and committed datasets reproducible.
        drng = np.random.default_rng(np.uint64(scale * 1e9))
        for ph, fr in ((drng.uniform(0, np.pi), 2.2),
                       (drng.uniform(0, np.pi), 3.1)):
            pz = pz - detail * scale * np.exp(
                -((np.sin(fr * th + ph) * rr / palm_r) ** 2) * 18.0
            )
    pts.append(np.stack([px, py, pz], 1))
    cols.append(np.tile(np.array(PALM_COLOR, np.uint8), (n_p, 1)))

    # forearm stub below the palm (labeled as palm — same part)
    arm_w = 1.1 * palm_r
    arm_l = 70.0 * scale
    n_a = int(1.4 * arm_w * arm_l)
    ax = rng.uniform(-0.5, 0.5, n_a) * arm_w
    ay = -palm_r * 0.8 - rng.uniform(0, 1, n_a) * arm_l
    az = np.full(n_a, 8.0 * scale)
    pts.append(np.stack([ax, ay, az], 1).astype(np.float32))
    cols.append(np.tile(np.array(PALM_COLOR, np.uint8), (n_a, 1)))

    # fingers: 3-segment chains from the palm rim (+y = away from the arm)
    for k in range(5):
        base_ang = np.deg2rad(30.0 + 30.0 * k)  # spread across the top
        base_ang += rng.uniform(-0.09, 0.09)
        base = np.array(
            [palm_r * np.cos(base_ang) * 0.95,
             palm_r * np.sin(base_ang) * 0.95, 12.0 * scale], np.float32
        )
        seg_len = np.array([52.0, 36.0, 26.0]) * scale * (
            1.0 + 0.22 * np.sin(np.pi * k / 4)
        )
        seg_rad = np.array([13.5, 11.5, 9.5]) * scale
        flex = rng.uniform(0.0, 1.0) * flex_scale  # 1 folds over the palm
        j_ang = np.deg2rad(
            np.array([
                rng.uniform(-8, 20) + 62 * flex,
                rng.uniform(0, 16) + 46 * flex,
                rng.uniform(0, 10) + 28 * flex,
            ])
        )
        dir2 = np.array([np.cos(base_ang), np.sin(base_ang)], np.float32)
        off_axis = np.array([-dir2[1], dir2[0], 0.0], np.float32)
        pos = base.copy()
        pitch = 0.0  # cumulative flex out of the palm plane
        for s in range(3):
            pitch += j_ang[s]
            # pitch > 90 deg reverses in-plane travel: the fingertip curls
            # back over the palm while rising
            d3 = np.array(
                [dir2[0] * np.cos(pitch), dir2[1] * np.cos(pitch),
                 np.sin(pitch)], np.float32
            )
            n_s = int(1.6 * seg_len[s] * 2.2 * seg_rad[s])
            t = rng.uniform(0, 1, n_s)
            ring = rng.uniform(0, np.pi, n_s)  # upper half circumference
            p = (
                pos[None, :]
                + t[:, None] * d3[None, :] * seg_len[s]
                + np.cos(ring)[:, None] * off_axis[None, :] * seg_rad[s]
            )
            zz = p[:, 2] + np.sin(ring) * seg_rad[s] * 0.8 + seg_rad[s] * 0.4
            if detail > 0:
                # knuckle ridge at the segment base + fine skin relief
                zz = zz + detail * scale * (
                    np.exp(-((t - 0.08) ** 2) * 120.0)
                    + 0.35 * np.sin(t * seg_len[s] * 0.9 + ring * 2.0)
                )
            pts.append(
                np.stack([p[:, 0], p[:, 1], zz], 1).astype(np.float32)
            )
            cols.append(
                np.tile(np.array(FINGER_COLORS[k], np.uint8), (n_s, 1))
            )
            pos = pos + d3 * seg_len[s]

    return np.concatenate(pts).astype(np.float32), np.concatenate(cols)


def apply_sensor_noise(depth, rng, *, noise_scale=1.0):
    """D415-style stereo-sensor degradation of a clean uint16 depth frame
    (0.1 mm units) — the realism axis the reference's data has for free by
    being captured live (live_data_convert.py) and clean splats lack:

    * depth noise growing ~z^2 (stereo subpixel error: sigma = s * z^2 /
      (f * B); ~2 units RMS at table depth, scaled by ``noise_scale``),
    * disparity quantization (depth rounds to z^2-proportional steps),
    * edge dropout: pixels near strong depth discontinuities go MISSING
      (stereo matchers fail across occlusion boundaries),
    * salt speckle: isolated missing pixels.

    Zero pixels stay zero (already missing).  Returns uint16."""
    h, w = depth.shape
    d = depth.astype(np.float32)
    valid = d > 0
    z2 = (d / 2600.0) ** 2

    # subpixel stereo noise, sigma ~2 units at the 2600-unit table
    sigma = 2.0 * noise_scale * z2
    d = d + rng.standard_normal((h, w)).astype(np.float32) * sigma

    # disparity quantization: step ~1.2 units at table depth
    step = np.maximum(1.2 * noise_scale * z2, 1e-3)
    d = np.round(d / step) * step

    # edge dropout: strong local depth contrast kills stereo matching
    pad = np.pad(d, 1, mode="edge")
    gx = np.abs(pad[1:-1, 2:] - pad[1:-1, :-2])
    gy = np.abs(pad[2:, 1:-1] - pad[:-2, 1:-1])
    edge = np.maximum(gx, gy) > 60.0
    drop_p = np.where(edge, 0.45 * noise_scale, 0.0)
    # speckle: isolated missing pixels anywhere
    drop_p = drop_p + 0.004 * noise_scale
    dropped = rng.uniform(0, 1, (h, w)) < drop_p

    out = np.clip(d, 0, 65535).astype(np.uint16)
    out[dropped | ~valid] = 0
    return out


def table_depth(intrin, normal=(0.02, -0.04, 1.0), z0=2600.0):
    """Tilted table plane depth image (float32, depth units)."""
    h, w = intrin.height, intrin.width
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    n = np.asarray(normal, np.float64)
    n = n / np.linalg.norm(n)
    return (
        z0 - n[0] * (xx - intrin.ppx) * 8 - n[1] * (yy - intrin.ppy) * 8
    ) / n[2]


def splat_hand(intrin, table_z, local, cols, cx, cy, height, rot_a=0.0,
               mirror=False):
    """Place a hand_cloud at image position (cx, cy), ``height`` depth units
    above the table, in-plane rotation ``rot_a``; ``mirror=True`` renders it
    as a LEFT hand (local x negated).  Returns (depth u16, color u8) hand
    layers (0 where no hand) via the splat z-buffer renderer."""
    h, w = intrin.height, intrin.width
    local = local.copy()
    if mirror:
        local[:, 0] = -local[:, 0]
    xy = local[:, :2] @ _rot2(rot_a).T

    zc = float(table_z[int(cy), int(cx)])
    unit = zc / intrin.fx  # 1 hand unit ~ 1 px at table depth
    X = (cx - intrin.ppx) * zc / intrin.fx + xy[:, 0] * unit
    # image y grows downward; +y toward fingers renders fingers-up
    Y = (cy - intrin.ppy) * zc / intrin.fy - xy[:, 1] * unit
    Z = zc - height - local[:, 2] * unit

    n_pts = local.shape[0]
    assert n_pts <= h * w, "hand cloud larger than the canvas"
    pts_img = np.zeros((h * w, 4), np.float32)
    pts_img[:n_pts, 0] = X
    pts_img[:n_pts, 1] = Y
    pts_img[:n_pts, 2] = Z
    pts_img[:n_pts, 3] = 1.0
    cols_img = np.zeros((h * w, 3), np.uint8)
    cols_img[:n_pts] = cols

    d_hand, c_hand = splat_points(
        pts_img.reshape(h, w, 4), cols_img.reshape(h, w, 3),
        np.array([intrin.ppx, intrin.ppy], np.float32), np.float32(intrin.fx),
    )
    d_hand, c_hand = fill_holes(d_hand, c_hand)
    d_hand, c_hand = fill_holes(d_hand, c_hand)
    return d_hand, c_hand


def splat_points(pts, colors, pp, focal):
    """(depth uint16, color uint8) images from an (H, W, 4) float32 point
    cloud (w == 1 valid) and its (H, W, 3) uint8 colors: each point lands on
    its rounded projected pixel, the nearest z wins and exact z ties go to
    the lowest source index (the z-buffer of beats3d_tpu/ops/render.py)."""
    h, w = pts.shape[:2]
    p = pts.reshape(-1, 4)
    x, y, z, wv = p[:, 0], p[:, 1], p[:, 2], p[:, 3]
    valid = (wv == 1.0) & (z > 0.0)
    zs = np.where(z <= 0, np.float32(1.0), z)
    u = np.round(focal * x / zs + pp[0]).astype(np.int32)
    v = np.round(focal * y / zs + pp[1]).astype(np.int32)
    inb = valid & (u >= 0) & (u < w) & (v >= 0) & (v < h)
    src = np.flatnonzero(inb)
    tgt = v[src] * w + u[src]
    zi = np.clip(z[src], 0, MAX_UINT16 - 1).astype(np.int32)

    zbuf = np.full(h * w, MAX_UINT16, np.int32)
    np.minimum.at(zbuf, tgt, zi)
    won = zi == zbuf[tgt]
    winner = np.full(h * w, h * w, np.int64)
    np.minimum.at(winner, tgt[won], src[won])

    has = zbuf != MAX_UINT16
    depth = np.where(has, zbuf, 0).astype(np.uint16).reshape(h, w)
    color = np.zeros((h * w, 3), np.uint8)
    color[has] = colors.reshape(-1, 3)[winner[has]]
    return depth, color.reshape(h, w, 3)


def fill_holes(depth, color):
    """Close 1-pixel rendering holes: a zero-depth pixel with >= 3 of its 4
    neighbours populated takes the neighbour min depth and that neighbour's
    colour (first of up, down, left, right on ties)."""
    d = depth.astype(np.int32)
    dn = np.where(d == 0, MAX_UINT16, d)
    pad = np.pad(dn, 1, constant_values=MAX_UINT16)
    shifts = [pad[:-2, 1:-1], pad[2:, 1:-1], pad[1:-1, :-2], pad[1:-1, 2:]]
    cpad = np.pad(color, ((1, 1), (1, 1), (0, 0)))
    cshifts = [cpad[:-2, 1:-1], cpad[2:, 1:-1], cpad[1:-1, :-2],
               cpad[1:-1, 2:]]
    present = sum((s != MAX_UINT16).astype(np.int32) for s in shifts)
    nmin, cmin = shifts[0], cshifts[0]
    for s, cs in zip(shifts[1:], cshifts[1:]):
        take = s < nmin
        cmin = np.where(take[..., None], cs, cmin)
        nmin = np.where(take, s, nmin)
    fill = (d == 0) & (present >= 3)
    out_d = np.where(fill, nmin, d)
    out_d = np.where(out_d == MAX_UINT16, 0, out_d).astype(np.uint16)
    out_c = np.where(fill[..., None], cmin, color)
    return out_d, out_c


def compose(table_z, layers):
    """Merge hand layers over the table by nearest depth.  Returns
    (depth u16, color u8)."""
    depth = table_z.astype(np.uint16)
    color = np.zeros(table_z.shape + (3,), np.uint8)
    for d_hand, c_hand in layers:
        on = (d_hand > 0) & (d_hand < depth)
        depth[on] = d_hand[on]
        color[on] = c_hand[on]
    return depth, color


def articulated_scene(intrin, rng, two_hands=False, flex_scale=1.0,
                      height_range=(260.0, 420.0), detail=0.0,
                      noise_scale=0.0):
    """A full-res articulated-hand frame over a tilted table.

    One random-pose right hand (``two_hands=False``, the training
    generator), or a right + mirrored-left pair placed left/right like the
    instrument's operating pose (``two_hands=True``, the bench scene).
    Returns (depth uint16, color uint8)."""
    h, w = intrin.height, intrin.width
    tz = table_depth(intrin)
    layers = []
    if two_hands:
        placements = [
            (rng.uniform(0.22, 0.38) * w, False),
            (rng.uniform(0.62, 0.78) * w, True),
        ]
    else:
        placements = [(rng.uniform(0.28, 0.72) * w, False)]
    for cx, mirror in placements:
        local, cols = hand_cloud(rng, flex_scale=flex_scale, detail=detail)
        cy = rng.uniform(0.38, 0.72) * h
        height = rng.uniform(*height_range)
        rot = rng.uniform(-0.45, 0.45)
        layers.append(
            splat_hand(intrin, tz, local, cols, cx, cy, height, rot,
                       mirror=mirror)
        )
    depth, color = compose(tz, layers)
    if noise_scale > 0:
        depth = apply_sensor_noise(depth, rng, noise_scale=noise_scale)
    return depth, color
