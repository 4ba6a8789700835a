"""Connected components + two-hand group selection on the device (counterpart
of beats3d_tpu/ops/components.py), and the frame's whole grouping stage.

One kernel, ``hand_groups`` in csrc/components.cu, serves three entries for
CUDA tensors, one block per image, with no host read:

* :func:`hand_groups_grown` (the frame programs' stage): shrink, labels,
  selection, groups and the 1-pixel grow in one launch;
* :func:`make_hand_groups`: the same without the grow;
* :func:`label_components`: the labels only.

An image of more than ``BLOCK_PIXELS`` pixels (one block's shared memory:
the mipmaps of ``depth_mm_level`` <= 1 at 848x480) takes the multi-block
path instead, :func:`hand_groups_multiblock` (five launches over 32x32
tiles, the labels and uint64 sums in device memory, no host read), in the
same three modes and with the same outputs.

For CPU tensors each runs its plain version, the composition the JAX
package computes: :func:`label_components_plain`, union-find to a fixpoint
in rounds of 8 neighbour-min propagations (shifts only) and two
pointer-jumping compressions ``lab = lab[lab]`` (an index gather; the JAX
package's one-hot matmul gather is a TPU workaround), with its fixpoint
test read on the host once per round; :func:`make_hand_groups_plain`, the
selection in tensor operations; and ``points.shrink_image`` and
``points.grow_groups`` around them.  Labels converge to the minimum linear
index of each 4-connected component, whatever the order of work, so the
kernel and the plain versions equal the JAX package's exactly.  There is no
fallback from one to the other.

Selection: components of size <= pct_thresh * num_pixels are discarded;
among the rest, the largest with centroid x < W/2 becomes group 1 ("right
hand": the image is mirrored) and the largest with centroid x >= W/2 group
2.  Ties go to the smaller root, the first maximum of ``argmax``.  The
kernels sum each root's size, x and y as integers; the plain version's
float32 ``scatter_add`` gives the same values while they stay below 2**24,
which holds for every image of up to ``BLOCK_PIXELS`` pixels whose sides
are at most 578 (an image's sum of x is at most n (W - 1) / 2).  Past that
the kernels' sums stay exact and the plain version's round (ROADMAP C-w15).

Functions take a leading batch dimension or none.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import cuda_lib, points

# One block's shared memory on the H100 (227 KB) holds the single-block
# kernel's int32 labels of one image; a larger image takes the multi-block
# path.
BLOCK_PIXELS = 232448 // 4
# The multi-block path indexes pixels in 32 bits and tiles rows in a grid
# of at most 65,535 tiles of 32.
MULTIBLOCK_ROWS = 65535 * 32


def label_components_plain(mask):
    """The kernel's plain labels, on any device: 4-connected component
    labels of a boolean mask (..., H, W).

    Returns int64 labels of the same shape: for mask pixels the linear index
    (within its image) of the component root, the minimum index of the
    component; for background H*W.
    """
    lead = mask.shape[:-2]
    h, w = mask.shape[-2:]
    n = h * w
    m = mask.reshape(-1, h, w)
    b = m.shape[0]
    dev = mask.device
    lin = torch.arange(n, dtype=torch.int64, device=dev).view(1, h, w)
    big = n
    lab = torch.where(m, lin, big)

    def neighbor_min(img):
        pad = F.pad(img, (1, 1, 1, 1), value=big)
        nb = torch.minimum(
            torch.minimum(pad[:, :-2, 1:-1], pad[:, 2:, 1:-1]),
            torch.minimum(pad[:, 1:-1, :-2], pad[:, 1:-1, 2:]),
        )
        return torch.where(m, torch.minimum(img, nb), big)

    # flat per-image tables with a self-looping background slot at index n
    sentinel = torch.full((b, 1), big, dtype=torch.int64, device=dev)

    def compress(img):
        flat = torch.cat([img.reshape(b, n), sentinel], dim=1)
        jumped = torch.gather(flat, 1, img.reshape(b, n)).reshape(b, h, w)
        return torch.where(m, jumped, img)

    while True:
        prev = lab
        for _ in range(8):
            lab = neighbor_min(lab)
        lab = compress(compress(lab))
        if not bool((lab != prev).any()):
            break
    return lab.reshape(*lead, h, w)


def make_hand_groups_plain(depth_small, pct_thresh):
    """:func:`make_hand_groups` in tensor operations, on any device."""
    lead = depth_small.shape[:-2]
    h, w = depth_small.shape[-2:]
    n = h * w
    dev = depth_small.device
    mask = depth_small.reshape(-1, h, w).to(torch.int32) > 0
    b = mask.shape[0]
    labels = label_components_plain(mask)

    seg = labels.reshape(b, n).clamp(max=n - 1)
    ones = mask.reshape(b, n).to(torch.float32)
    xs = torch.arange(w, dtype=torch.float32, device=dev).repeat(h)
    ys = torch.arange(h, dtype=torch.float32, device=dev).view(h, 1).expand(
        h, w).reshape(-1)

    def seg_sum(vals):
        return torch.zeros((b, n), dtype=torch.float32, device=dev).scatter_add_(
            1, seg, vals)

    sizes = seg_sum(ones)
    sx = seg_sum(ones * xs)
    sy = seg_sum(ones * ys)
    safe_sizes = torch.where(sizes == 0, 1.0, sizes)
    cx = sx / safe_sizes
    cy = sy / safe_sizes

    # both as device scalars made by a fill, not copied from the host: a
    # CUDA graph captures the fill; the division stays IEEE (a Python
    # divisor goes through its reciprocal on CUDA)
    n_f = torch.full((), float(n), dtype=torch.float32, device=dev)
    if not torch.is_tensor(pct_thresh):
        pct_thresh = torch.full((), float(pct_thresh), dtype=torch.float32,
                                device=dev)
    surviving = sizes / n_f > pct_thresh
    is_right = cx < (w / 2.0)
    right_score = torch.where(surviving & is_right, sizes, 0.0)
    left_score = torch.where(surviving & ~is_right, sizes, 0.0)
    r_root = torch.argmax(right_score, dim=1, keepdim=True)
    l_root = torch.argmax(left_score, dim=1, keepdim=True)

    def pick(t, idx):
        return torch.gather(t, 1, idx)[:, 0]

    r_size = pick(right_score, r_root)
    l_size = pick(left_score, l_root)
    lab = labels.reshape(b, n)
    groups = torch.zeros((b, n), dtype=torch.int32, device=dev)
    groups = torch.where((lab == r_root) & (r_size > 0)[:, None], 1, groups)
    groups = torch.where((lab == l_root) & (l_size > 0)[:, None], 2, groups)
    g_info = torch.stack([
        torch.stack([r_size, pick(cx, r_root), pick(cy, r_root)], dim=-1),
        torch.stack([l_size, pick(cx, l_root), pick(cy, l_root)], dim=-1),
    ], dim=1)
    return (groups.reshape(*lead, h, w).to(depth_small.dtype),
            g_info.reshape(*lead, 2, 3))


def hand_groups_grown_plain(depth1, level: int, pct_thresh):
    """:func:`hand_groups_grown` in tensor operations, on any device: the
    composition ``shrink_image`` -> :func:`make_hand_groups_plain` ->
    ``grow_groups``."""
    small = points.shrink_image(depth1, level)
    groups, g_info = make_hand_groups_plain(small, pct_thresh)
    return points.grow_groups(groups), g_info, groups


def _hand_groups_cuda(depth, level, pct_thresh, *, labels=False, grown=False):
    """One call of the grouping kernel on depth (..., H, W), a CUDA tensor,
    at mipmap ``level``: the single-block kernel's one launch, or for an
    image of more than ``BLOCK_PIXELS`` pixels the multi-block path
    (:func:`hand_groups_multiblock`).  Returns the (B, h, w) int64 labels,
    or (groups, g_info, grown or None) with groups and grown (B, h, w)
    int32 and g_info (B, 2, 3) float32, and whether the multi-block path
    ran."""
    hh, ww = depth.shape[-2:]
    f = 1 << level
    h, w = -(-hh // f), -(-ww // f)
    if h * w == 0 and not labels:
        raise ValueError(f"hand_groups: a {h}x{w} image has no pixels")
    multi = h * w > BLOCK_PIXELS
    if multi and (h * w >= 2 ** 31 or h > MULTIBLOCK_ROWS):
        raise ValueError(
            f"hand_groups: a {h}x{w} image; the multi-block path takes fewer "
            f"than 2**31 pixels and at most {MULTIBLOCK_ROWS} rows")
    dev = depth.device
    d = depth.reshape(-1, hh, ww).to(torch.int32)
    b = d.shape[0]
    sb, sh, sw = d.stride()
    if labels:
        outs = (None, torch.empty((b, h, w), dtype=torch.int64, device=dev),
                None, None, None)
    else:
        pct = (pct_thresh if torch.is_tensor(pct_thresh) else torch.full(
            (), float(pct_thresh), dtype=torch.float32, device=dev))
        pct = pct.to(device=dev, dtype=torch.float32)
        if pct.numel() != 1:
            raise ValueError(f"hand_groups: pct_thresh has {pct.numel()} "
                             "values, want one")
        outs = (pct, None,
                torch.empty((b, h, w), dtype=torch.int32, device=dev),
                torch.empty((b, h, w), dtype=torch.int32, device=dev)
                if grown else None,
                torch.empty((b, 2, 3), dtype=torch.float32, device=dev))
    args = (d, (sb, sh * f, sw * f), h, w, outs)
    if multi:
        hand_groups_multiblock(*args)
    else:
        lib = cuda_lib.library()
        _launch(lib.b3d_hand_groups,
                0 if labels else lib.b3d_hand_groups_scratch(h, w), *args)
    _, out, groups, grown_t, g_info = outs
    return (out if labels else (groups, g_info, grown_t)), multi


def _launch(entry, ints, d, strides, h, w, outs):
    """One call of a grouping entry on the (B, H, W) int32 depth ``d`` read
    at ``strides`` as h x w images, with ``ints`` int32 of scratch per image
    and ``outs`` (pct, labels, groups, grown, g_info), each a CUDA tensor or
    None."""
    b = d.shape[0]
    scratch = (torch.empty(b * ints, dtype=torch.int32, device=d.device)
               if ints else None)
    ptrs = [None if t is None else t.data_ptr() for t in (*outs, scratch)]
    with torch.cuda.device(d.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = entry(d.data_ptr(), *strides, b, h, w, *ptrs, stream)
    cuda_lib.check(status, "hand_groups")


def hand_groups_multiblock(d, strides, h, w, outs):
    """The multi-block path (csrc/components.cu, b3d_hand_groups_mb): five
    launches over 32x32 tiles, three in the labels-only mode, with the
    labels and uint64 sums in a scratch of device memory; arguments as
    :func:`_launch`'s.  :func:`label_components`, :func:`make_hand_groups`
    and :func:`hand_groups_grown` send an image of more than
    ``BLOCK_PIXELS`` pixels here; its ``launches`` count its calls."""
    lib = cuda_lib.library()
    _launch(lib.b3d_hand_groups_mb, lib.b3d_hand_groups_mb_scratch(h, w), d,
            strides, h, w, outs)
    hand_groups_multiblock.launches += 1


def label_components(mask):
    """4-connected component labels of a boolean mask (..., H, W), as
    :func:`label_components_plain` returns them: the kernel's labels-only
    mode for a CUDA tensor, the plain version for a CPU tensor.

    On CUDA: returns int64; an image of more than ``BLOCK_PIXELS`` pixels
    takes the multi-block path.
    """
    if mask.device.type != "cuda":
        return label_components_plain(mask)
    out, multi = _hand_groups_cuda(mask, 0, None, labels=True)
    label_components.launches += not multi
    return out.reshape(mask.shape)


def make_hand_groups(depth_small, pct_thresh):
    """Connected components on a small depth image + left/right hand
    selection: the kernel without the grow for a CUDA tensor, the plain
    version for a CPU tensor.

    depth_small: (..., H, W) integer depth (the 1/8 mipmap level).
    pct_thresh: minimum component size as a fraction of the image (strictly
    greater passes): a number, or a float32 scalar tensor on the depth's
    device (the pipeline's ``gms``), which the kernel reads in place.

    Returns groups (..., H, W) in the depth's dtype (1 right-hand component,
    2 left-hand component, 0 elsewhere) and g_info (..., 2, 3) float32 rows
    (size, centroid_x, centroid_y) for (right, left); size 0 = no group.
    """
    if depth_small.device.type != "cuda":
        return make_hand_groups_plain(depth_small, pct_thresh)
    lead = depth_small.shape[:-2]
    (groups, g_info, _), multi = _hand_groups_cuda(depth_small, 0, pct_thresh)
    make_hand_groups.launches += not multi
    return (groups.reshape(depth_small.shape).to(depth_small.dtype),
            g_info.reshape(*lead, 2, 3))


def hand_groups_grown(depth1, level: int, pct_thresh):
    """The frame's grouping stage: ``depth1[..., ::2**level, ::2**level]``
    -> :func:`make_hand_groups` -> ``points.grow_groups``, one kernel
    launch for a CUDA tensor (the shrunk image read at stride, with no
    copy), the plain composition for a CPU tensor.

    depth1 (..., H, W) integer depth; pct_thresh as for
    :func:`make_hand_groups`.  Returns (grown, g_info, groups_small): grown
    and groups_small (..., Hs, Ws) in depth1's dtype, g_info (..., 2, 3)
    float32.
    """
    if depth1.device.type != "cuda":
        return hand_groups_grown_plain(depth1, level, pct_thresh)
    lead = depth1.shape[:-2]
    (groups, g_info, grown), multi = _hand_groups_cuda(
        depth1, level, pct_thresh, grown=True)
    hand_groups_grown.launches += not multi
    shape = (*lead, *groups.shape[-2:])
    return (grown.reshape(shape).to(depth1.dtype), g_info.reshape(*lead, 2, 3),
            groups.reshape(shape).to(depth1.dtype))


# Kernel launches so far, per wrapper (the CPU path does not count): the
# single-block kernel's per entry, the multi-block path's for all three.
label_components.launches = 0
make_hand_groups.launches = 0
hand_groups_grown.launches = 0
hand_groups_multiblock.launches = 0
