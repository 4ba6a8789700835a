"""Training split bits (kernel B4, csrc/train_features.cu), the counterpart
of beats3d_tpu/ops/train_features_pallas.py:train_feature_bits.

:func:`train_feature_bits_cuda` launches the CUDA kernel for CUDA tensors and
runs its plain version, :func:`.train_features.train_feature_bits_plain`, for
CPU tensors.  There is no fallback from one to the other.
"""

from __future__ import annotations

import torch

from . import cuda_lib
from .train_features import train_feature_bits_plain

MAX_PROPOSALS = 2048   # 64 words: blockIdx.y holds words x row tiles


def train_feature_bits_cuda(depth, props, active=None):
    """Packed split bits ``f < thresh`` of every (pixel, proposal).

    depth: (N, H, W); props: (P, 5) float32 (ux, uy, vx, vy, thresh);
    active: optional (N, H, W) bool.  Returns (N, ceil(P/32), H, W) int32,
    0 at inactive pixels.  On CUDA: depth contiguous int32, props
    contiguous float32 with 1 <= P <= 2048 and active contiguous bool, all
    on one card.  On the CPU: the plain version.
    """
    if depth.device.type != "cuda":
        return train_feature_bits_plain(depth, props, active)
    if depth.dtype != torch.int32 or not depth.is_contiguous() or depth.dim() != 3:
        raise ValueError(
            f"train_feature_bits_cuda: depth must be contiguous (N, H, W) "
            f"int32, got {depth.dtype} {tuple(depth.shape)}")
    if (props.device != depth.device or props.dtype != torch.float32
            or not props.is_contiguous() or props.dim() != 2
            or props.shape[1] != 5
            or not 1 <= props.shape[0] <= MAX_PROPOSALS):
        raise ValueError(
            f"train_feature_bits_cuda: props must be a contiguous (P, 5) "
            f"float32 tensor on the depth's device with 1 <= P <= "
            f"{MAX_PROPOSALS}, got {props.dtype} {tuple(props.shape)} on "
            f"{props.device}")
    if active is not None and (
            active.device != depth.device or active.dtype != torch.bool
            or not active.is_contiguous() or active.shape != depth.shape):
        raise ValueError(
            "train_feature_bits_cuda: active must be a contiguous bool "
            "tensor of the depth's shape on its device")
    n, h, w = depth.shape
    p = props.shape[0]
    out = torch.empty((n, (p + 31) // 32, h, w), dtype=torch.int32,
                      device=depth.device)
    lib = cuda_lib.library()
    with torch.cuda.device(depth.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.b3d_train_feature_bits(
            depth.data_ptr(), props.data_ptr(), p,
            None if active is None else active.data_ptr(), out.data_ptr(),
            n, h, w, stream,
        )
    cuda_lib.check(status, "train_feature_bits_cuda")
    train_feature_bits_cuda.launches += 1
    return out


# Kernel launches so far (the CPU path does not count).
train_feature_bits_cuda.launches = 0
