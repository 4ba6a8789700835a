"""Training-time split bits in plain PyTorch: the plain version of kernel B4
(:mod:`.train_features_cuda`), and the feature evaluation the trainer shares
with it (counterpart of beats3d_tpu/train/trainer.py:_chunk_features and of
the output contract of beats3d_tpu/ops/train_features_pallas.py).

For every (pixel, proposal) the histogram needs the split bit
``f < thresh``, with f the Shotton depth-difference feature at unit scale:
probe offsets ``floor(u / d)`` with IEEE float32 division, a probe out of
bounds reads 65535, and a centre depth of 0 gives f = 0.  Bits are packed 32
to an int32 word: bit ``p % 32`` of word ``p // 32`` belongs to proposal p.
"""

from __future__ import annotations

import torch

MAX_UINT16 = 65535
PIXEL_CHUNK = 1 << 16


def pixel_features(depth_flat, b, y, x, d_center, ux, uy, vx, vy,
                   h: int, w: int):
    """Depth-difference features at unit scale, all arguments broadcast
    together: pixel (b, y, x) of centre depth d_center with probe offsets
    u = (ux, uy), v = (vx, vy).  depth_flat: (N*H*W,) integer depth.
    Returns float32."""
    df = d_center.to(torch.float32)
    safe = torch.where(df == 0, 1.0, df)
    b, y, x = b.to(torch.int64), y.to(torch.int64), x.to(torch.int64)

    def probe(cx, cy):
        # the divisor is a tensor: IEEE division on every device
        ty = y + torch.floor(cy / safe).to(torch.int64)
        tx = x + torch.floor(cx / safe).to(torch.int64)
        inb = (ty >= 0) & (ty < h) & (tx >= 0) & (tx < w)
        lin = b * (h * w) + ty.clamp(0, h - 1) * w + tx.clamp(0, w - 1)
        vals = depth_flat[lin.clamp(0, depth_flat.shape[0] - 1)]
        return torch.where(inb, vals, MAX_UINT16).to(torch.float32)

    f = probe(ux, uy) - probe(vx, vy)
    return torch.where(df == 0, 0.0, f)


def chunk_features(depth_flat, b, y, x, d_center, props, h: int, w: int):
    """Features of a pixel chunk under all proposals.

    depth_flat: (N*H*W,) integer depth; b/y/x: (chunk,) image, row and
    column of each pixel; d_center: (chunk,) its depth; props: (P, 5)
    float32 (ux, uy, vx, vy, thresh) on the same device.  Returns (P, chunk)
    float32.
    """
    px = [a[None, :] for a in (b, y, x, d_center)]
    return pixel_features(depth_flat, *px, *(props[:, k : k + 1]
                                             for k in range(4)), h, w)


def pack_bits(bits):
    """(P, M) bool -> (ceil(P/32), M) int32, bit p % 32 of word p // 32."""
    p, m = bits.shape
    p32 = (p + 31) // 32
    padded = torch.zeros((p32 * 32, m), dtype=torch.int64, device=bits.device)
    padded[:p] = bits.to(torch.int64)
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    words = (padded.view(p32, 32, m) << shifts[None, :, None]).sum(dim=1)
    # two's complement: a set bit 31 is the int32 sign bit
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(torch.int32)


def train_feature_bits_plain(depth, props, active=None,
                             chunk: int = PIXEL_CHUNK):
    """Packed split bits of every (pixel, proposal).

    depth: (N, H, W) integer tensor; props: (P, 5) float32 on the same
    device; active: optional (N, H, W) bool, the pixels the histogram uses.
    Returns (N, ceil(P/32), H, W) int32.  An inactive pixel's words are 0
    (the kernel's; the JAX kernel leaves them undefined), so only active
    pixels carry bits that mean anything.
    """
    n, h, w = depth.shape
    hw = h * w
    p32 = (props.shape[0] + 31) // 32
    dev = depth.device
    flat = depth.reshape(-1).to(torch.int32)
    out = torch.zeros((n, p32, hw), dtype=torch.int32, device=dev)
    if active is None:
        idx = torch.arange(n * hw, dtype=torch.int64, device=dev)
    else:
        idx = torch.nonzero(active.reshape(-1)).reshape(-1)
    for lo in range(0, idx.shape[0], chunk):
        i = idx[lo : lo + chunk]
        b = i // hw
        rem = i % hw
        f = chunk_features(flat, b, rem // w, rem % w, flat[i], props, h, w)
        out[b, :, rem] = pack_bits(f < props[:, 4:5]).T
    return out.view(n, p32, h, w)
