"""A plain reference of routed layered forests, in plain torch, for the
port's tests: Keskin et al.'s local expert network (ECCV 2012), a coarse
hand layer, a router and K sibling expert forests,

    c(x)     = argmax_c sum_t P_{coarse,t}(c | x)
    r(x)     = argmax_k sum_t P_{R,t}(k | x)          where c(x) = hand
    label(x) = argmax_c sum_t P_{E_r(x),t}(c | x)     where r(x) >= 1

written from these equations and the dense forest format alone: it imports
no JAX and nothing of the port.  A forest's walk keeps the port's float32
order (leaf pdfs summed level by level, the trees of a level in tree
order; probe offsets ``floor(scale * u / d)``; out-of-bounds probes read
65535; the strictly-greater argmax from (0.0, class 0)), so labels compare
exactly.
"""

import numpy as np
import torch

MISSING = 65535


def walk(depth, flat, *, r, scale=1.0, mask=None):
    """Labels (N, H//r, W//r) int64 of one dense (T, 2**D - 1, 7 + 2C)
    forest on (N, H, W) integer depth, 65535 where the centre depth is 0
    or 65535 or ``mask`` is False."""
    depth = torch.as_tensor(depth).to(torch.int64)
    flat = torch.as_tensor(flat, dtype=torch.float32)
    n, h, w = depth.shape
    hl, wl = h // r, w // r
    trees, nodes, els = flat.shape
    levels = int(np.log2(nodes + 1))
    classes = (els - 7) // 2
    d = depth[:, : hl * r : r, : wl * r : r]
    eligible = (d != 0) & (d != MISSING)
    if mask is not None:
        eligible &= mask
    df = d.to(torch.float32)
    safe = torch.where(df == 0, 1.0, df)
    yy = (torch.arange(hl) * r).view(1, hl, 1).expand(n, hl, wl)
    xx = (torch.arange(wl) * r).view(1, 1, wl).expand(n, hl, wl)
    img = torch.arange(n).view(n, 1, 1).expand(n, hl, wl)

    def probe(oy, ox):
        y, x = yy + oy, xx + ox
        inside = (y >= 0) & (y < h) & (x >= 0) & (x < w)
        v = depth[img, y.clamp(0, h - 1), x.clamp(0, w - 1)]
        return torch.where(inside, v, MISSING).to(torch.float32)

    def offset(a):
        return torch.floor(scale * a / safe).to(torch.int64)

    rows = torch.zeros((trees, n, hl, wl), dtype=torch.int64)
    done = torch.zeros((trees, n, hl, wl), dtype=torch.bool)
    acc = torch.zeros((n, hl, wl, classes), dtype=torch.float32)
    for _ in range(levels):
        level = torch.zeros_like(acc)
        for t in range(trees):
            node = flat[t][rows[t]]
            f = (probe(offset(node[..., 1]), offset(node[..., 0]))
                 - probe(offset(node[..., 3]), offset(node[..., 2])))
            side = (~(f < node[..., 4])).to(torch.int64)
            nxt = torch.floor(torch.where(side == 1, node[..., 6],
                                          node[..., 5]))
            hit = ~done[t] & (nxt != -1)
            pdf = torch.where((side == 1)[..., None],
                              node[..., 7 + classes:], node[..., 7:7 + classes])
            level = level + torch.where(hit[..., None], pdf, 0.0)
            rows[t] = torch.where(~done[t] & (nxt == -1),
                                  2 * rows[t] + 1 + side, rows[t])
            done[t] |= hit
        acc = acc + level
    best_v = torch.zeros((n, hl, wl), dtype=torch.float32)
    best_c = torch.zeros((n, hl, wl), dtype=torch.int64)
    for c in range(classes):
        better = acc[..., c] > best_v
        best_v = torch.where(better, acc[..., c], best_v)
        best_c = torch.where(better, c, best_c)
    return torch.where(eligible, best_c, MISSING)


def run_routed(depth, coarse, router, experts, *, r, scale=1.0, hand=1):
    """(final labels (N, H//r, W//r) int64, per-forest label images in the
    order coarse, router, experts): a pixel takes its expert's label where
    that is a class above 0, else 65535."""
    c = walk(depth, coarse, r=r, scale=scale)
    route = walk(depth, router, r=r, scale=scale, mask=c == hand)
    out = torch.full_like(route, MISSING)
    images = [c, route]
    for k, e in enumerate(experts, start=1):
        lab = walk(depth, e, r=r, scale=scale, mask=route == k)
        out = torch.where((route == k) & (lab != 0) & (lab != MISSING),
                          lab, out)
        images.append(lab)
    return out, images
