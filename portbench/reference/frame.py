"""The plain frame program: the benchmark's reference for the live tick
(``BeatsApp.tick``) and the batched call (``FramePipeline.batch``).

A frozen copy of the port's plain versions (beats3d_tpu_torch/ops/points.py,
components.py, meanshift.py and runtime/pipeline.py's eager frame programs),
which the port's kernels and CUDA graphs are held to bit for bit:

    raw depth -> plane band + missing-aware 5x5 gaussian (K2's plain version)
      -> 1/8 mipmap -> union-find components -> hand selection -> 1-pixel
         grow (the grouping kernel's plain version)
      -> per-hand stencilled crops (the left hand mirrored), or the full
         frame when a hand exceeds the crop window; in a batch up to
         ``fallback_budget`` such frames rescued full-frame
      -> the layered forest (K1's plain version; the configuration's
         reference model, ``models``) -> mean shift
      -> fingertip heights above the plane from the raw depth

Where the program decides on the device (a conditional node of its CUDA
graph), this reads the predicate on the host and runs the branch taken.
``ftype`` is the type of K2's plane test and gaussian, of the forest's
feature and of mean shift: float32, as the configuration states, or a lower
one for the control.  Imports
nothing of the program.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

MAX_UINT16 = 65535


def _f32(v, device):
    return torch.as_tensor(v, dtype=torch.float32, device=device)


# -- points ------------------------------------------------------------------

def deproject_points(depth, pp, focal):
    """Depth (..., H, W) -> camera-space (..., H, W, 4) float32 points,
    (d*(x-ppx)/f, d*(y-ppy)/f, d, 1) where d > 0, else all zero."""
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


def plane_band_depth(depth, mat, pp, focal, threshold, ftype=torch.float32):
    """Keep a pixel when d > 0 and its plane-space z is not above
    -threshold, z = ((m20*px + m21*py) + m22*d) + m23."""
    h, w = depth.shape[-2:]
    dev = depth.device
    pp = _f32(pp, dev).to(ftype)
    f = _f32(focal, dev).to(ftype)
    x = torch.arange(w, dtype=ftype, device=dev).view(1, w)
    y = torch.arange(h, dtype=ftype, device=dev).view(h, 1)
    di = depth.to(torch.int32)
    d = di.to(ftype)
    px = d * (x - pp[0]) / f
    py = d * (y - pp[1]) / f
    m = _f32(mat, dev).to(ftype)
    z = ((m[2, 0] * px + m[2, 1] * py) + m[2, 2] * d) + m[2, 3]
    keep = (di > 0) & ~(z > -float(np.float32(threshold)))
    return torch.where(keep, di, 0)


def gaussian_kernel(k_size: int, sigma: float) -> np.ndarray:
    l = k_size // 2
    xs = np.linspace(-l, l, k_size)
    k1 = np.exp(-(xs ** 2) / (2.0 * sigma * sigma))
    k2 = np.outer(k1, k1)
    return (k2 / k2.sum()).astype(np.float32)


def gaussian_depth_filter(depth, kernel, ftype=torch.float32):
    """Missing-aware gaussian: in-bounds zero taps add their weight to w0,
    the others to wn and weight * depth to sn, taps summed in row-major
    order; 0 where w0 > wn, else floor(sn / wn)."""
    h, w = depth.shape[-2:]
    dev = depth.device
    kern = _f32(kernel, dev).to(ftype)
    k = kern.shape[0]
    half = k // 2
    d = depth.to(ftype)
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
    return out.to(torch.int32)


def grow_groups(g):
    """1-pixel 4-neighbour dilation: an empty pixel takes the first
    non-zero of its left, right, up, down neighbours."""
    h, w = g.shape[-2:]
    gi = g.to(torch.int32)
    p = F.pad(gi, (1, 1, 1, 1))
    out = gi
    filled = gi != 0
    for c in (p[..., 1:h + 1, 0:w], p[..., 1:h + 1, 2:w + 2],
              p[..., 0:h, 1:w + 1], p[..., 2:h + 2, 1:w + 1]):
        take = (~filled) & (c != 0)
        out = torch.where(take, c, out)
        filled = filled | take
    return out


def stencil(groups_small, depth, level: int, group: int):
    """Full-res depth where the low-res group image == group, else 0."""
    f = 1 << level
    *lead, hs, ws = groups_small.shape
    g_full = groups_small[..., :, None, :, None].expand(
        *lead, hs, f, ws, f).reshape(*lead, hs * f, ws * f)
    g_full = g_full[..., : depth.shape[-2], : depth.shape[-1]]
    return torch.where(g_full.to(torch.int32) == group,
                       depth.to(torch.int32), 0)


def crop(img, oy, ox, ch: int, cw: int):
    """(N, ch, cw) windows of (N, H, W) at origins (N,); 0 outside."""
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
    """Each (ch, cw) image on an (hh, ww) canvas of ``fill`` at its origin;
    the inverse of :func:`crop`."""
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
    return torch.flip(img, dims=(-1,))


def zeros_to_max(depth):
    return torch.where(depth == 0, MAX_UINT16, depth)


# -- components --------------------------------------------------------------

def label_components(mask):
    """4-connected component labels of a (B, H, W) bool mask: the minimum
    linear index of each component, H*W for background (union-find to a
    fixpoint: rounds of 8 neighbour-min propagations and two pointer
    jumps)."""
    b, h, w = mask.shape
    n = h * w
    dev = mask.device
    lin = torch.arange(n, dtype=torch.int64, device=dev).view(1, h, w)
    big = n
    lab = torch.where(mask, lin, big)

    def neighbor_min(img):
        pad = F.pad(img, (1, 1, 1, 1), value=big)
        nb = torch.minimum(
            torch.minimum(pad[:, :-2, 1:-1], pad[:, 2:, 1:-1]),
            torch.minimum(pad[:, 1:-1, :-2], pad[:, 1:-1, 2:]))
        return torch.where(mask, torch.minimum(img, nb), big)

    sentinel = torch.full((b, 1), big, dtype=torch.int64, device=dev)

    def compress(img):
        flat = torch.cat([img.reshape(b, n), sentinel], dim=1)
        jumped = torch.gather(flat, 1, img.reshape(b, n)).reshape(b, h, w)
        return torch.where(mask, jumped, img)

    while True:
        prev = lab
        for _ in range(8):
            lab = neighbor_min(lab)
        lab = compress(compress(lab))
        if not bool((lab != prev).any()):
            return lab


def hand_groups(depth_small, pct_thresh: float):
    """(B, Hs, Ws) mipmap -> groups (B, Hs, Ws) int32 (1 the largest
    surviving component with centroid x < W/2, 2 the largest at or past
    it; ties to the smaller root) and g_info (B, 2, 3) (size, cx, cy)."""
    b, h, w = depth_small.shape
    n = h * w
    dev = depth_small.device
    mask = depth_small.to(torch.int32) > 0
    labels = label_components(mask)
    seg = labels.reshape(b, n).clamp(max=n - 1)
    ones = mask.reshape(b, n).to(torch.float32)
    xs = torch.arange(w, dtype=torch.float32, device=dev).repeat(h)
    ys = torch.arange(h, dtype=torch.float32, device=dev).view(h, 1).expand(
        h, w).reshape(-1)

    def seg_sum(vals):
        return torch.zeros((b, n), dtype=torch.float32,
                           device=dev).scatter_add_(1, seg, vals)

    sizes = seg_sum(ones)
    sx = seg_sum(ones * xs)
    sy = seg_sum(ones * ys)
    safe = torch.where(sizes == 0, 1.0, sizes)
    cx, cy = sx / safe, sy / safe
    n_f = torch.full((), float(n), dtype=torch.float32, device=dev)
    pct = torch.full((), float(pct_thresh), dtype=torch.float32, device=dev)
    surviving = sizes / n_f > pct
    is_right = cx < (w / 2.0)
    right_score = torch.where(surviving & is_right, sizes, 0.0)
    left_score = torch.where(surviving & ~is_right, sizes, 0.0)
    r_root = torch.argmax(right_score, dim=1, keepdim=True)
    l_root = torch.argmax(left_score, dim=1, keepdim=True)

    def pick(t, idx):
        return torch.gather(t, 1, idx)[:, 0]

    r_size, l_size = pick(right_score, r_root), pick(left_score, l_root)
    lab = labels.reshape(b, n)
    groups = torch.zeros((b, n), dtype=torch.int32, device=dev)
    groups = torch.where((lab == r_root) & (r_size > 0)[:, None], 1, groups)
    groups = torch.where((lab == l_root) & (l_size > 0)[:, None], 2, groups)
    g_info = torch.stack([
        torch.stack([r_size, pick(cx, r_root), pick(cy, r_root)], dim=-1),
        torch.stack([l_size, pick(cx, l_root), pick(cy, l_root)], dim=-1),
    ], dim=1)
    return groups.reshape(b, h, w), g_info


# -- mean shift --------------------------------------------------------------

def mean_shift(labels, variances, *, num_classes: int, num_rounds: int,
               ftype=torch.float32):
    """Per-class modes (..., C, 2) (x, y) of label images; NaN for absent
    classes.  Round 0 takes each class's centroid, each later round shifts
    by sum(p * diff) / sum(p), p = exp(-|diff|^2 / (2 var^2))."""
    lead = labels.shape[:-2]
    h, w = labels.shape[-2:]
    dev = labels.device
    l = labels.reshape(-1, 1, h, w).to(torch.int32)
    xs = torch.arange(w, dtype=ftype, device=dev).view(1, 1, 1, w)
    ys = torch.arange(h, dtype=ftype, device=dev).view(1, 1, h, 1)
    class_ids = torch.arange(1, num_classes + 1, dtype=torch.int32,
                             device=dev).view(1, -1, 1, 1)
    masks = (l == class_ids).to(ftype)
    counts = masks.sum(dim=(2, 3))
    sum_x = (masks * xs).sum(dim=(2, 3))
    sum_y = (masks * ys).sum(dim=(2, 3))
    absent = counts == 0
    means = torch.stack([sum_x, sum_y], dim=-1) / torch.clamp(
        counts, min=1.0)[..., None]
    var = torch.as_tensor(variances, dtype=ftype, device=dev)
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
    return means.to(torch.float32).reshape(*lead, num_classes, 2)


# -- the frame program -------------------------------------------------------

class RefPipeline:
    """The reference frame program for one model, camera and pipeline
    configuration (the configuration file's ``camera`` and ``pipeline``
    sections), on ``device``, evaluating ``model`` with ``run_layered``
    (the pair that ``models.load`` resolves from the configuration).
    ``visits``, when a list, receives the (stack shape, per-layer walk
    visits) of every layered evaluation: the K1 launches a call stands
    for, for the work counts."""

    def __init__(self, model, camera: dict, pipeline: dict, device, *,
                 run_layered, ftype=torch.float32):
        self.model = model
        self.run_layered = run_layered
        self.cam = camera
        self.p = pipeline
        self.dev = torch.device(device)
        self.ftype = ftype
        self.pp = np.array([camera["ppx"], camera["ppy"]], np.float32)
        self.fx = float(camera["fx"])
        self.fy = float(camera["fy"])
        c = model.num_classes
        self.variances = np.array(
            [pipeline["mean_shift_variance_hand"]]
            + [pipeline["mean_shift_variance_tip"]] * (c - 1), np.float32)
        self.tip_rows = torch.tensor(pipeline["fingertip_label_ids"],
                                     dtype=torch.int64, device=self.dev) - 1
        self.guarded = (pipeline["guard_spread"] > 0
                        and pipeline["guard_mode"] == "skip"
                        and model.conditions_np.shape[0] <= 128)
        self.visits = None

    # pieces
    def _front(self, raw):
        p = self.p
        d1 = plane_band_depth(raw, self.plane, self.pp, self.fx,
                              p["plane_z_threshold"], self.ftype)
        d1 = gaussian_depth_filter(
            d1, gaussian_kernel(p["gauss_kernel_size"], p["gauss_sigma"]),
            self.ftype)
        lvl = p["depth_mm_level"]
        f = 1 << lvl
        groups, g_info = hand_groups(d1[..., ::f, ::f], p["group_min_size"])
        return d1, grow_groups(groups), g_info

    def _scale(self, w):
        return float(np.float32(w) / np.float32(self.p["train_dim_x"]))

    def _eval(self, imgs, scale):
        """Layered labels of an (N, H, W) hand stack with the incoherence
        guard; (labels, guard flags (N,))."""
        r = self.p["labels_reduce"]
        flags = torch.zeros(imgs.shape[0], dtype=torch.bool, device=self.dev)
        if self.guarded:
            flags = self._incoherent(imgs, r)
            imgs = torch.where(flags[:, None, None], 0, imgs)
        lv = None if self.visits is None else []
        lab = self.run_layered(imgs, self.model, labels_reduce=r,
                               scale_factor=scale, visits=lv,
                               ftype=self.ftype)
        if lv is not None:
            self.visits.append((tuple(imgs.shape), lv))
        return lab, flags

    def _incoherent(self, imgs, r):
        p = self.p
        n = imgs.shape[0]
        c = imgs[:, ::r, ::r].to(torch.int32)
        hl, wl = c.shape[1], c.shape[2]
        hp = ((hl + 7) // 8) * 8
        wp = ((wl + 127) // 128) * 128
        t = F.pad(c, (0, wp - wl, 0, hp - hl)).reshape(
            n, hp // 8, 8, wp // 128, 128)
        valid = (t > 0) & (t < MAX_UINT16)
        tmin = torch.where(valid, t, 1 << 20).amin(dim=(2, 4))
        tmax = torch.where(valid, t, -1).amax(dim=(2, 4))
        occupied = tmax >= 0
        spread = occupied & ((tmax - tmin) > p["guard_spread"])
        n_occ = torch.clamp(occupied.sum(dim=(1, 2)), min=1).to(torch.float32)
        frac = spread.sum(dim=(1, 2)).to(torch.float32) / n_occ
        return frac > p["guard_tile_frac"]

    def _ms(self, labels):
        return mean_shift(labels, self.variances,
                          num_classes=self.model.num_classes,
                          num_rounds=self.p["mean_shift_rounds"],
                          ftype=self.ftype)

    def _crop_origins(self, grown, h, w):
        p = self.p
        ch, cw = p["crop_h"], p["crop_w"]
        f = 1 << p["depth_mm_level"]
        if f % p["labels_reduce"] != 0:
            f *= p["labels_reduce"]
        hs, ws = grown.shape[-2:]
        masks = torch.stack([grown == 1, grown == 2], dim=1)
        rows = masks.any(dim=3).to(torch.int32)
        cols = masks.any(dim=2).to(torch.int32)
        ylo = rows.argmax(dim=-1) * f
        yhi = ((hs - rows.flip(-1).argmax(dim=-1)) * f).clamp(max=h)
        xlo = cols.argmax(dim=-1) * f
        xhi = ((ws - cols.flip(-1).argmax(dim=-1)) * f).clamp(max=w)
        xlo, xhi = (torch.stack([xlo[:, 0], w - xhi[:, 1]], dim=1),
                    torch.stack([xhi[:, 0], w - xlo[:, 1]], dim=1))

        def origin(lo, hi, crop_, dim):
            c = ((lo + hi - crop_) // 2).clamp(0, dim - crop_)
            return ((c // f) * f).to(torch.int32)

        present = rows.any(dim=-1)
        too_big = (present & ((yhi - ylo > ch - f + 1)
                              | (xhi - xlo > cw - f + 1))).any(dim=1)
        return origin(ylo, yhi, ch, h), origin(xlo, xhi, cw, w), too_big

    def _full(self, d1, grown, keep=None):
        b, h, w = d1.shape
        r = self.p["labels_reduce"]
        lvl = self.p["depth_mm_level"]
        hand = zeros_to_max(torch.stack(
            [stencil(grown, d1, lvl, 1), flip_x(stencil(grown, d1, lvl, 2))],
            dim=-3))
        if keep is not None:
            hand = torch.where(keep[:, None, None, None], hand, 0)
        lab, gf = self._eval(hand.reshape(2 * b, h, w), self._scale(w))
        lab = lab.reshape(b, 2, h // r, w // r)
        labels = torch.stack([lab[:, 0], flip_x(lab[:, 1])], dim=1)
        return labels, self._ms(labels), gf.reshape(b, 2)

    def _crop(self, d1, grown, oys, oxs, too_big=None):
        b, h, w = d1.shape
        p = self.p
        r = p["labels_reduce"]
        ch, cw = p["crop_h"], p["crop_w"]
        lvl = p["depth_mm_level"]
        f = 1 << lvl
        out = []
        for hand, ox in ((0, oxs[:, 0]), (1, w - cw - oxs[:, 1])):
            oy = oys[:, hand]
            d = crop(d1, oy, ox, ch, cw)
            g = crop(grown, oy // f, ox // f, ch // f, cw // f)
            s = stencil(g, d, lvl, hand + 1)
            out.append(flip_x(s) if hand else s)
        crops = zeros_to_max(torch.stack(out, dim=1))
        if too_big is not None:
            crops = torch.where(too_big[:, None, None, None], 0, crops)
        lc, gf = self._eval(crops.reshape(2 * b, ch, cw), self._scale(w))
        lc = lc.reshape(b, 2, ch // r, cw // r)
        hl, wl = h // r, w // r
        placed = place(MAX_UINT16, lc.reshape(2 * b, ch // r, cw // r),
                       (oys // r).reshape(-1), (oxs // r).reshape(-1),
                       hl, wl).reshape(b, 2, hl, wl)
        labels = torch.stack([placed[:, 0], flip_x(placed[:, 1])], dim=1)
        m = self._ms(lc)
        sx = (oxs // r).to(torch.float32)[..., None] + m[..., 0]
        sy = (oys // r).to(torch.float32)[..., None] + m[..., 1]
        sx = torch.stack([sx[:, 0], (wl - 1) - sx[:, 1]], dim=1)
        return labels, torch.stack([sx, sy], dim=-1), gf.reshape(b, 2)

    def _heights(self, raw, means):
        """Fingertip heights (B, 2, F), valid (B, 2, F): the mode pixel
        times labels_reduce, its raw depth deprojected, height = -z in
        plane space (the plane row applied as a chain of float32
        multiply-adds, each rounded once)."""
        b, h, w = raw.shape
        r = self.p["labels_reduce"]
        c = means.shape[-2]
        sel = self.tip_rows
        in_range = sel < c
        m = means[..., sel.clamp(0, c - 1), :]
        nanmask = torch.isnan(m).any(dim=-1)
        m_safe = torch.where(torch.isnan(m), -1.0, m)
        px = m_safe[..., 0].to(torch.int32) * r
        py = m_safe[..., 1].to(torch.int32) * r
        valid = (in_range & ~nanmask & (px >= 0) & (py >= 0) & (px < w)
                 & (py < h))
        pxc, pyc = px.clamp(0, w - 1), py.clamp(0, h - 1)
        lin = (pyc.to(torch.int64) * w + pxc).reshape(b, -1)
        z = torch.gather(raw.reshape(b, h * w), 1, lin).reshape(
            pxc.shape).to(torch.float32)
        pp = _f32(self.pp, self.dev)
        fx = torch.tensor(self.fx, dtype=torch.float32, device=self.dev)
        fy = torch.tensor(self.fy, dtype=torch.float32, device=self.dev)
        X = z * (pxc.to(torch.float32) - pp[0]) / fx
        Y = z * (pyc.to(torch.float32) - pp[1]) / fy
        pm = self.plane
        pz = None
        for a, k in ((X, pm[2, 0]), (Y, pm[2, 1]), (z, pm[2, 2]),
                     (torch.ones_like(z), pm[2, 3])):
            prod = a.to(torch.float64) * k.to(torch.float64)
            pz = (prod if pz is None else prod + pz.to(torch.float64)).to(
                torch.float32)
        return -pz, valid

    def _outputs(self, raw, labels, means, gmut, g_info):
        heights, valid = self._heights(raw, means)
        return dict(labels=labels, means=means, heights=heights,
                    tip_valid=valid, g_info=g_info, guard_muted=gmut)

    def _use_crop(self, h, w):
        p = self.p
        return (p["crop_h"] < h and p["crop_w"] < w and p["crop_h"] % 16 == 0
                and p["crop_w"] % 16 == 0)

    # entries
    def frame(self, raw, plane):
        """One (H, W) int32 frame -> the live tick's outputs (no batch
        axis)."""
        out = self.batch(raw[None], plane, live=True)
        return {k: v[0] for k, v in out.items()}

    def batch(self, raw, plane, live=False):
        """(B, H, W) int32 frames with one plane -> the batched call's
        outputs (``live``: the single frame's program: crop or full)."""
        self.plane = plane.to(self.dev, torch.float32)
        b, h, w = raw.shape
        d1, grown, g_info = self._front(raw)
        if not self._use_crop(h, w):
            return self._outputs(raw, *self._full(d1, grown), g_info)
        oys, oxs, too_big = self._crop_origins(grown, h, w)
        if live:
            res = (self._full(d1, grown) if bool(too_big[0])
                   else self._crop(d1, grown, oys, oxs))
            return self._outputs(raw, *res, g_info)
        nbad = int(too_big.sum())
        fb = min(self.p["fallback_budget"], b)
        if fb == 0:
            res = (self._full(d1, grown) if nbad > 0
                   else self._crop(d1, grown, oys, oxs, too_big))
        elif nbad > fb:
            res = self._full(d1, grown)
        else:
            cropped = self._crop(d1, grown, oys, oxs, too_big)
            if nbad == 0:
                res = cropped
            else:
                ar = torch.arange(b, device=self.dev)
                idx = torch.argsort(torch.where(too_big, ar, b + ar))[:fb]
                upd = too_big[idx]
                rescued = self._full(d1[idx], grown[idx], keep=upd)
                res = tuple(
                    c.index_copy(0, idx, torch.where(
                        upd.view((-1,) + (1,) * (c.dim() - 1)), r, c[idx]))
                    for r, c in zip(rescued, cropped))
        return self._outputs(raw, *res, g_info)
