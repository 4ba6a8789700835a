"""The plain versions of the hand-image and label kernels
(ops/hand_images_cuda.py) against a numpy reference written here: crop,
stencil, mirror, sentinel, zeroing and the incoherence guard on the way into
K1, placing and unmirroring on the way out.  The same cases run the kernels
against these plain versions on the card (tests/test_torch_cuda.py)."""

import numpy as np
import pytest
import torch

import fixtures

from beats3d_tpu_torch.ops import hand_images_cuda

MISSING = 65535


def ref_hand_images(depth1, grown, level, *, window=None, origins=None,
                    frames=None, mute=None, keep=None, guard=None):
    """(images (2B', ch, cw), muted (2B',)): image 2i + k is pair i's hand k
    (group k + 1), the left hand mirrored, cut from the frame's stencil at
    its window (pixels outside the frame 0), 0 -> 65535, zeroed pairs 0,
    then the guard."""
    b, h, w = depth1.shape
    f = 1 << level
    frames = np.arange(b) if frames is None else frames
    imgs = []
    for i, fr in enumerate(frames):
        g = np.repeat(np.repeat(grown[fr], f, 0), f, 1)[:h, :w]
        for k in (0, 1):
            s = np.where(g == k + 1, depth1[fr], 0)
            if window is None:
                img = s
            else:
                ch, cw = window
                oy = origins[0][i, k]
                ox = origins[1][i, k] if k == 0 else w - cw - origins[1][i, k]
                img = np.zeros((ch, cw), np.int64)
                for y in range(ch):
                    for x in range(cw):
                        if 0 <= oy + y < h and 0 <= ox + x < w:
                            img[y, x] = s[oy + y, ox + x]
            if k:
                img = img[:, ::-1]
            img = np.where(img == 0, MISSING, img)
            if ((mute is not None and mute[i])
                    or (keep is not None and not keep[i])):
                img = np.zeros_like(img)
            imgs.append(img)
    imgs = np.stack(imgs).astype(np.int64)
    muted = np.zeros(len(imgs), bool)
    if guard is not None:
        r, spread, frac = guard
        for n, img in enumerate(imgs):
            c = img[::r, ::r]
            occ = over = 0
            for y0 in range(0, c.shape[0], 8):
                for x0 in range(0, c.shape[1], 128):
                    t = c[y0:y0 + 8, x0:x0 + 128]
                    v = t[(t > 0) & (t < MISSING)]
                    if v.size:
                        occ += 1
                        over += int(v.max() - v.min() > spread)
            muted[n] = (np.float32(over) / np.float32(max(occ, 1))
                        > np.float32(frac))
        imgs[muted] = 0
    return imgs, muted


def ref_place_labels(labels, r, *, origins=None, canvas=None):
    """(B, 2, Hl, Wl) screen-frame labels: each crop's labels at origin // r
    on a canvas of 65535 (the left hand's in mirrored space), the left hand
    then unmirrored; without origins only unmirrored."""
    b, _, lh, lw = labels.shape
    hl, wl = (lh, lw) if canvas is None else canvas
    out = np.full((b, 2, hl, wl), MISSING, np.int64)
    for i in range(b):
        for k in (0, 1):
            oy = 0 if origins is None else origins[0][i, k] // r
            ox = 0 if origins is None else origins[1][i, k] // r
            canvas_k = np.full((hl, wl), MISSING, np.int64)
            for y in range(lh):
                for x in range(lw):
                    if 0 <= oy + y < hl and 0 <= ox + x < wl:
                        canvas_k[oy + y, ox + x] = labels[i, k, y, x]
            out[i, k] = canvas_k[:, ::-1] if k else canvas_k
    return out


@pytest.mark.parametrize("variant", list(fixtures.HAND_VARIANTS))
@pytest.mark.parametrize("guard", ["off", "flagged", "clean"])
@pytest.mark.parametrize("body", ["crop", "full"])
def test_hand_images_and_labels_plain_match_numpy(body, guard, variant):
    """hand_images and place_labels on the CPU (their plain versions) equal
    the numpy reference on every case: crop and whole frame, one frame and
    16, levels 1 and 3, labels_reduce 1 and 2, origins at 0, at the far
    edge and past it, zeroed pairs, the guard off, flagging and clean, and
    the rescue's frame index."""
    case = fixtures.hand_image_case(np.random.default_rng(7), body, guard,
                                    variant)
    depth1 = torch.as_tensor(case["depth1"])
    grown = torch.as_tensor(case["grown"])
    imgs, muted = hand_images_cuda.hand_images(
        depth1, grown, case["level"], **fixtures.as_tensors(case["kw"]))
    want, want_muted = ref_hand_images(case["depth1"], case["grown"],
                                       case["level"], **case["kw"])
    assert imgs.dtype == torch.int32 and muted.dtype == torch.bool
    np.testing.assert_array_equal(imgs.numpy(), want)
    np.testing.assert_array_equal(muted.numpy(), want_muted)
    # a flagging case flags something, and a clean one nothing
    assert want_muted.any() == (guard == "flagged")
    labels = hand_images_cuda.place_labels(
        torch.as_tensor(case["labels"]), case["r"],
        **fixtures.as_tensors(case["place_kw"]))
    np.testing.assert_array_equal(
        labels.numpy(), ref_place_labels(case["labels"], case["r"],
                                         **case["place_kw"]))
