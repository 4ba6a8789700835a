"""Connected components + two-hand group selection on the device (counterpart
of beats3d_tpu/ops/components.py).

Labelling: :func:`label_components` launches the union-find kernel
(csrc/components.cu) for CUDA tensors, the counterpart of the JAX package's
``lax.while_loop``: the loop runs to its fixpoint on the card, one block
per image, with no host read.  For CPU tensors it runs the plain version,
:func:`label_components_plain`: union-find to a fixpoint in rounds of 8
neighbour-min propagations (shifts only) and two pointer-jumping
compressions ``lab = lab[lab]`` (an index gather; the JAX package's one-hot
matmul gather is a TPU workaround), with its fixpoint test read on the host
once per round.  Labels converge to the minimum linear index of each
4-connected component, whatever the order of work, so both equal the JAX
package's exactly.  There is no fallback from one to the other.

Selection: components of size <= pct_thresh * num_pixels are discarded;
among the rest, the largest with centroid x < W/2 becomes group 1 ("right
hand": the image is mirrored) and the largest with centroid x >= W/2 group
2.  Ties go to the smaller root, the first maximum of ``argmax``.  Per-root
sums use ``scatter_add`` in float32, exact below 2**24.

Functions take a leading batch dimension or none.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import cuda_lib

# One block's shared memory on the H100 (227 KB) holds the kernel's int32
# labels of one image.
MAX_PIXELS = 232448 // 4


def label_components_plain(mask):
    """The union-find kernel's plain version, on any device: 4-connected
    component labels of a boolean mask (..., H, W).

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


def label_components(mask):
    """4-connected component labels of a boolean mask (..., H, W), as
    :func:`label_components_plain` returns them: the kernel for a CUDA
    tensor, the plain version for a CPU tensor.

    On CUDA: an image of more than ``MAX_PIXELS`` pixels raises ValueError;
    returns int64 (the kernel writes the labels of one image per block).
    """
    if mask.device.type != "cuda":
        return label_components_plain(mask)
    lead = mask.shape[:-2]
    h, w = mask.shape[-2:]
    if h * w > MAX_PIXELS:
        raise ValueError(
            f"label_components: a {h}x{w} image has {h * w} pixels; the "
            f"kernel holds at most {MAX_PIXELS} (one block's 227 KB of shared "
            "memory as int32 labels)")
    m = mask.reshape(-1, h, w).to(torch.bool).contiguous()
    out = torch.empty(m.shape, dtype=torch.int64, device=mask.device)
    lib = cuda_lib.library()
    with torch.cuda.device(mask.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.b3d_label_components(m.data_ptr(), out.data_ptr(),
                                          m.shape[0], h, w, stream)
    cuda_lib.check(status, "label_components")
    label_components.launches += 1
    return out.reshape(*lead, h, w)


# Kernel launches so far (the CPU path does not count).
label_components.launches = 0


def make_hand_groups(depth_small, pct_thresh):
    """Connected components on a small depth image + left/right hand
    selection.

    depth_small: (..., H, W) integer depth (the 1/8 mipmap level).
    pct_thresh: minimum component size as a fraction of the image (strictly
    greater passes): a number, or a float32 scalar tensor on the depth's
    device (the pipeline's ``gms``), which a CUDA graph reads in place.

    Returns groups (..., H, W) in the depth's dtype (1 right-hand component,
    2 left-hand component, 0 elsewhere) and g_info (..., 2, 3) float32 rows
    (size, centroid_x, centroid_y) for (right, left); size 0 = no group.
    """
    lead = depth_small.shape[:-2]
    h, w = depth_small.shape[-2:]
    n = h * w
    dev = depth_small.device
    mask = depth_small.reshape(-1, h, w).to(torch.int32) > 0
    b = mask.shape[0]
    labels = label_components(mask)

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
