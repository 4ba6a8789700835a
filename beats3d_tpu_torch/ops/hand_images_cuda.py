"""K1's input and output moved by hand-written kernels
(csrc/hand_images.cu): the per-hand images the layered forest reads, cut,
stencilled, mirrored, zeroed and guarded in one pass, and its labels placed
on the screen-frame canvas and unmirrored in one.  JAX builds both with
XLA operations (beats3d_tpu/runtime/pipeline.py); the plain versions here
are the same composition in ATen.

:func:`hand_images` and :func:`place_labels` launch the kernels for CUDA
tensors and run the plain versions for CPU tensors.  There is no fallback
from one to the other.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from . import cuda_lib, points

MAX_UINT16 = 65535
# a guard tile: 8 x 128 samples of the labels_reduce grid
TILE_ROWS, TILE_COLS = 8, 128


def full_stencils(depth1, grown, level: int):
    """Full-resolution per-hand stack (..., 2, H, W): right, mirrored left."""
    d_right = points.stencil_depth_image_by_group(grown, depth1, level, 1)
    d_left = points.flip_x(
        points.stencil_depth_image_by_group(grown, depth1, level, 2))
    return points.convert_0s_to_maxuint(torch.stack([d_right, d_left], dim=-3))


def stencil_crops(depth1, grown, oys, oxs, level: int, ch: int, cw: int):
    """Per-hand stencilled (B, 2, ch, cw) crops cut straight from depth1
    (B, H, W) / grown (B, Hs, Ws) at the origins ``oys``, ``oxs`` (B, 2);
    the left hand's (mirrored-space) origin maps to an unmirrored window
    flipped after stencilling.  Bit-identical to cropping
    :func:`full_stencils` at origins that are multiples of 2**level."""
    f = 1 << level
    w = depth1.shape[-1]
    out = []
    for hand, ox in ((0, oxs[:, 0]), (1, w - cw - oxs[:, 1])):
        oy = oys[:, hand]
        d = points.crop(depth1, oy, ox, ch, cw)
        g = points.crop(grown, oy // f, ox // f, ch // f, cw // f)
        s = points.stencil_depth_image_by_group(g, d, level, hand + 1)
        out.append(points.flip_x(s) if hand else s)
    return points.convert_0s_to_maxuint(torch.stack(out, dim=1))


def spread_tiles(depth_imgs, r: int, spread: int):
    """Per-(image, 8x128 label tile) (occupied, over-spread) masks: a tile is
    over-spread when its valid-depth range exceeds ``spread``."""
    n = depth_imgs.shape[0]
    c = depth_imgs[:, ::r, ::r].to(torch.int32)
    hl, wl = c.shape[1], c.shape[2]
    hp = _cdiv(hl, TILE_ROWS) * TILE_ROWS
    wp = _cdiv(wl, TILE_COLS) * TILE_COLS
    t = F.pad(c, (0, wp - wl, 0, hp - hl)).reshape(
        n, hp // TILE_ROWS, TILE_ROWS, wp // TILE_COLS, TILE_COLS)
    valid = (t > 0) & (t < MAX_UINT16)
    tmin = torch.where(valid, t, 1 << 20).amin(dim=(2, 4))
    tmax = torch.where(valid, t, -1).amax(dim=(2, 4))
    occupied = tmax >= 0
    return occupied, occupied & ((tmax - tmin) > spread)


def incoherent_images(depth_imgs, r: int, spread: int, tile_frac: float):
    """The incoherence guard's per-image flags: (N,) bool, True for images
    whose own over-spread tile fraction exceeds ``tile_frac``."""
    occupied, over = spread_tiles(depth_imgs, r, spread)
    n_occ = torch.clamp(occupied.sum(dim=(1, 2)), min=1).to(torch.float32)
    frac = over.sum(dim=(1, 2)).to(torch.float32) / n_occ
    return frac > tile_frac


def hand_images_plain(depth1, grown, level: int, *, window=None,
                      origins=None, frames=None, mute=None, keep=None,
                      guard=None):
    """:func:`hand_images`' plain version, on any device."""
    if frames is not None:
        depth1, grown = depth1[frames], grown[frames]
    if window is None:
        imgs = full_stencils(depth1, grown, level)
    else:
        imgs = stencil_crops(depth1, grown, *origins, level, *window)
    if mute is not None:
        imgs = torch.where(mute[:, None, None, None], 0, imgs)
    if keep is not None:
        imgs = torch.where(keep[:, None, None, None], imgs, 0)
    imgs = imgs.reshape(-1, *imgs.shape[-2:])
    if guard is None:
        return imgs, torch.zeros(imgs.shape[0], dtype=torch.bool,
                                 device=imgs.device)
    flags = incoherent_images(imgs, *guard)
    return torch.where(flags[:, None, None], 0, imgs), flags


def _check_int(what, t, shape, dtype):
    if (not torch.is_tensor(t) or t.dtype != dtype or not t.is_contiguous()
            or tuple(t.shape) != tuple(shape)):
        raise ValueError(f"hand_images_cuda: {what} must be a contiguous "
                         f"{dtype} tensor of shape {tuple(shape)}")


def _cdiv(a, b):
    return -(-a // b)


def _ptr(t):
    return None if t is None else t.data_ptr()


def hand_images(depth1, grown, level: int, *, window=None, origins=None,
                frames=None, mute=None, keep=None, guard=None):
    """The per-hand images K1 reads, and the guard's flags.

    depth1 (B, H, W) depth and grown (B, Hs, Ws) hand groups at mipmap
    level ``level`` (group 1 the right hand, 2 the left).  Image 2i is pair
    i's right hand, 2i + 1 its left hand mirrored; pair i reads frame
    ``frames[i]`` ((B',) int64; default frame i).  ``window`` (ch, cw) with
    ``origins`` (oys, oxs), each (B', 2) int32: a crop per hand at the
    origin (the left hand's given in mirrored space); without: the whole
    frame.  A hand's depth where its group lies, 0 elsewhere and outside the
    frame; then 0 -> 65535.  ``mute`` / ``keep`` (B',) bool: pairs whose
    flag is set / not set are 0 throughout.  ``guard`` (r, spread,
    tile_frac): images whose occupied 8x128 label tiles (of the stride-r
    grid) are over-spread beyond tile_frac are 0 throughout, and flagged.

    Returns (images (2B', ch, cw), muted (2B',) bool; no flag without a
    guard).  On CUDA: one launch (two under the guard), every tensor
    contiguous on one card, depth and grown int32, images int32.  On the
    CPU: the plain version, in depth1's dtype.
    """
    if depth1.device.type != "cuda":
        return hand_images_plain(depth1, grown, level, window=window,
                                 origins=origins, frames=frames, mute=mute,
                                 keep=keep, guard=guard)
    if depth1.dim() != 3 or grown.dim() != 3:
        raise ValueError("hand_images: depth1 and grown must be (B, H, W)")
    b, h, w = depth1.shape
    hs, ws = grown.shape[1:]
    f = 1 << level
    _check_int("depth1", depth1, (b, h, w), torch.int32)
    _check_int("grown", grown, (b, hs, ws), torch.int32)
    pairs = b
    if frames is not None:
        pairs = frames.shape[0]
        _check_int("frames", frames, (pairs,), torch.int64)
    if window is None:
        if origins is not None:
            raise ValueError("hand_images: origins without a window")
        if hs * f < h or ws * f < w:
            raise ValueError(f"hand_images: groups {hs}x{ws} at level "
                             f"{level} do not cover {h}x{w}")
        ch, cw, oys, oxs = h, w, None, None
    else:
        ch, cw = window
        if ch % f or cw % f:
            raise ValueError(f"hand_images: window {ch}x{cw} is not a "
                             f"multiple of 2**level")
        oys, oxs = origins
        _check_int("oys", oys, (pairs, 2), torch.int32)
        _check_int("oxs", oxs, (pairs, 2), torch.int32)
    if mute is not None and keep is not None:
        raise ValueError("hand_images: mute and keep together")
    zero = mute if mute is not None else keep
    if zero is not None:
        _check_int("mute/keep", zero, (pairs,), torch.bool)
    for t in (grown, frames, oys, oxs, zero):
        if t is not None and t.device != depth1.device:
            raise ValueError("hand_images: inputs on more than one device")
    dev = depth1.device
    out = torch.empty((2 * pairs, ch, cw), dtype=torch.int32, device=dev)
    muted = torch.empty(2 * pairs, dtype=torch.bool, device=dev)
    codes, r, spread, frac = None, 1, 0, 0.0
    if guard is not None:
        r, spread, frac = guard
        tiles = (_cdiv(_cdiv(ch, r), TILE_ROWS)
                 * _cdiv(_cdiv(cw, r), TILE_COLS))
        codes = torch.empty(2 * pairs * tiles, dtype=torch.uint8, device=dev)
    lib = cuda_lib.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.b3d_hand_images(
            depth1.data_ptr(), grown.data_ptr(), _ptr(frames), _ptr(oys),
            _ptr(oxs), _ptr(zero), int(mute is not None), out.data_ptr(),
            _ptr(codes), muted.data_ptr(), pairs, h, w, hs, ws, ch, cw,
            level, int(r), int(spread), float(np.float32(frac)), stream)
    cuda_lib.check(status, "hand_images")
    hand_images.launches += 1
    return out, muted


def place_labels_plain(labels, r: int, *, origins=None, canvas=None):
    """:func:`place_labels`' plain version, on any device."""
    if origins is not None:
        b, _, lh, lw = labels.shape
        oys, oxs = origins
        labels = points.place(
            MAX_UINT16, labels.reshape(2 * b, lh, lw), (oys // r).reshape(-1),
            (oxs // r).reshape(-1), *canvas).reshape(b, 2, *canvas)
    return torch.stack([labels[:, 0], points.flip_x(labels[:, 1])], dim=1)


def place_labels(labels, r: int, *, origins=None, canvas=None):
    """K1's per-hand labels -> screen-frame labels.

    labels (B, 2, lh, lw): each pair's right hand, then its left hand
    mirrored.  With ``origins`` (oys, oxs), each (B, 2) int32 at full
    resolution (the left hand's in mirrored space), and ``canvas`` (Hl,
    Wl): each crop's labels placed at origin // r on a canvas of 65535;
    without, the labels are the whole frame.  The left hand is then
    unmirrored.  Returns (B, 2, Hl, Wl).  On CUDA: one launch, every tensor
    contiguous on one card, labels int32.  On the CPU: the plain version.
    """
    if labels.device.type != "cuda":
        return place_labels_plain(labels, r, origins=origins, canvas=canvas)
    if labels.dim() != 4 or labels.shape[1] != 2:
        raise ValueError(f"place_labels: labels shape {tuple(labels.shape)}")
    b, _, lh, lw = labels.shape
    _check_int("labels", labels, labels.shape, torch.int32)
    oys = oxs = None
    if origins is None:
        hl, wl = lh, lw
    else:
        hl, wl = canvas
        oys, oxs = origins
        _check_int("oys", oys, (b, 2), torch.int32)
        _check_int("oxs", oxs, (b, 2), torch.int32)
        if oys.device != labels.device or oxs.device != labels.device:
            raise ValueError("place_labels: inputs on more than one device")
    out = torch.empty((b, 2, hl, wl), dtype=torch.int32, device=labels.device)
    lib = cuda_lib.library()
    with torch.cuda.device(labels.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.b3d_place_labels(
            labels.data_ptr(), _ptr(oys), _ptr(oxs), out.data_ptr(), b, lh,
            lw, hl, wl, int(r), stream)
    cuda_lib.check(status, "place_labels")
    place_labels.launches += 1
    return out


# Kernel launches so far, per wrapper (the CPU path does not count): a
# guarded hand_images call is counted once for its two kernels.
hand_images.launches = 0
place_labels.launches = 0
