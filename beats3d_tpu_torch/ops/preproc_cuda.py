"""Fused plane-band filter + missing-aware gaussian (kernel K2,
csrc/preproc.cu), the counterpart of beats3d_tpu/ops/preproc_pallas.py.

:func:`plane_band_gauss_cuda` launches the CUDA kernel for CUDA tensors and runs
its plain version, ``points.plane_band_depth`` followed by
``points.gaussian_depth_filter``, for CPU tensors.  There is no fallback
from one to the other.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import cuda_lib, points

KSIZE = 5


def plane_band_gauss_plain(depth, mat, pp, focal, threshold, *,
                           ksize: int = KSIZE, sigma: float = 2.0):
    """The kernel's plain version, on any device."""
    d1 = points.plane_band_depth(depth, mat, pp, focal, threshold)
    return points.gaussian_depth_filter(
        d1, points.gaussian_kernel(ksize, sigma))


@functools.lru_cache(maxsize=None)
def kernel_taps(ksize: int = KSIZE, sigma: float = 2.0):
    """The kernel's taps argument, built once per process: the k*k weights
    of ``points.gaussian_kernel`` in row-major order, then their row-major
    float32 sum (the ``wn`` of a pixel whose taps are all kept)."""
    taps = points.gaussian_kernel(ksize, sigma).reshape(-1)
    wn_all = np.float32(0.0)
    for t in taps:
        wn_all = np.float32(wn_all + t)
    return (ctypes.c_float * (taps.size + 1))(*taps.tolist(), float(wn_all))


def plane_band_gauss_cuda(depth, mat, pp, focal, threshold, *,
                     ksize: int = KSIZE, sigma: float = 2.0):
    """Fused ``plane_band_depth`` + ``gaussian_depth_filter``.

    depth: (H, W) or (B, H, W); mat: (4, 4) float32 camera->plane matrix
    (row 2 is read); pp (2,), focal and threshold: host numbers.
    On CUDA: depth must be contiguous int32 and mat a float32 tensor on the
    same card; returns int32.  On the CPU: the plain version, in the
    depth's dtype.
    """
    if depth.device.type != "cuda":
        return plane_band_gauss_plain(
            depth, mat, pp, focal, threshold, ksize=ksize, sigma=sigma)
    if ksize != KSIZE:
        raise ValueError(f"the CUDA kernel has {KSIZE}x{KSIZE} taps, not {ksize}")
    if depth.dtype != torch.int32 or not depth.is_contiguous():
        raise ValueError("plane_band_gauss: depth must be contiguous int32")
    if depth.dim() not in (2, 3):
        raise ValueError(f"plane_band_gauss: depth shape {tuple(depth.shape)}")
    if (not torch.is_tensor(mat) or mat.device != depth.device
            or mat.dtype != torch.float32 or tuple(mat.shape) != (4, 4)
            or not mat.is_contiguous()):
        raise ValueError(
            "plane_band_gauss: mat must be a contiguous (4, 4) float32 tensor "
            "on the depth's device")
    d3 = depth if depth.dim() == 3 else depth[None]
    b, h, w = d3.shape
    out = torch.empty_like(d3)
    lib = cuda_lib.library()
    with torch.cuda.device(depth.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.b3d_plane_band_gauss(
            d3.data_ptr(), out.data_ptr(), b, h, w, mat.data_ptr(),
            float(np.float32(pp[0])), float(np.float32(pp[1])),
            float(np.float32(focal)), float(np.float32(threshold)),
            kernel_taps(ksize, float(sigma)), stream,
        )
    cuda_lib.check(status, "plane_band_gauss")
    plane_band_gauss_cuda.launches += 1
    return out if depth.dim() == 3 else out[0]


# Kernel launches so far (the CPU path does not count).
plane_band_gauss_cuda.launches = 0
