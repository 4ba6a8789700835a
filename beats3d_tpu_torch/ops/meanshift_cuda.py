"""Per-class mean shift in one kernel launch (csrc/mean_shift.cu), every
round and class of a batch of label images together.  JAX runs
beats3d_tpu/ops/meanshift.py:mean_shift as XLA operations (no
``pallas_call``); the kernel's plain version is :func:`meanshift.mean_shift`.

:func:`mean_shift_cuda` launches the kernel for CUDA tensors and runs the
plain version for CPU tensors.  There is no fallback from one to the other.
"""

from __future__ import annotations

import math

import torch

from . import cuda_lib, meanshift


def mean_shift_cuda(labels, variances, *, num_classes: int,
                    num_rounds: int = 6):
    """:func:`meanshift.mean_shift` as one launch.

    labels: (..., H, W) label images; 0, 65535 and anything outside
    1..num_classes are background.  variances: (num_classes,) float32.
    Returns (..., num_classes, 2) float32 (x, y) modes, NaN for absent
    classes.  On CUDA: labels must be contiguous int32 and variances a
    contiguous float32 tensor of num_classes entries on the same card.  On
    the CPU: the plain version.
    """
    if labels.device.type != "cuda":
        return meanshift.mean_shift(labels, variances, num_classes=num_classes,
                                    num_rounds=num_rounds)
    if labels.dtype != torch.int32 or not labels.is_contiguous():
        raise ValueError("mean_shift: labels must be contiguous int32")
    if labels.dim() < 2:
        raise ValueError(f"mean_shift: labels shape {tuple(labels.shape)}")
    if num_classes < 1:
        raise ValueError(f"mean_shift: {num_classes} classes")
    if (not torch.is_tensor(variances) or variances.device != labels.device
            or variances.dtype != torch.float32
            or tuple(variances.shape) != (num_classes,)
            or not variances.is_contiguous()):
        raise ValueError(
            "mean_shift: variances must be a contiguous (num_classes,) "
            "float32 tensor on the labels' device")
    lead = labels.shape[:-2]
    h, w = labels.shape[-2:]
    n = math.prod(lead)
    out = torch.empty((n, num_classes, 2), dtype=torch.float32,
                      device=labels.device)
    lib = cuda_lib.library()
    with torch.cuda.device(labels.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.b3d_mean_shift(
            labels.data_ptr(), variances.data_ptr(), out.data_ptr(), n, h, w,
            num_classes, num_rounds, stream)
    cuda_lib.check(status, "mean_shift")
    mean_shift_cuda.launches += 1
    return out.reshape(*lead, num_classes, 2)


# Kernel launches so far (the CPU path does not count).
mean_shift_cuda.launches = 0
