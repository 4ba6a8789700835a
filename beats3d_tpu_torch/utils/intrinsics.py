# Copied from beats3d_tpu/utils/intrinsics.py (numpy / host only).
"""Camera intrinsics + projection helpers (reference src/rs_util.py:38-47,
src/util.py:12-19)."""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class CameraIntrinsics:
    """Pinhole intrinsics of the depth stream (RealSense D415-style)."""

    width: int
    height: int
    fx: float
    fy: float
    ppx: float
    ppy: float

    @property
    def pp(self) -> np.ndarray:
        return np.array([self.ppx, self.ppy], dtype=np.float32)

    def deproject_pixel_to_point(self, px: float, py: float, z: float):
        """rs2_deproject_pixel_to_point equivalent for the no-distortion depth
        stream: (z*(px-ppx)/fx, z*(py-ppy)/fy, z)."""
        return np.array(
            [z * (px - self.ppx) / self.fx, z * (py - self.ppy) / self.fy, z],
            dtype=np.float64,
        )

    @staticmethod
    def d415(width: int = 848, height: int = 480) -> "CameraIntrinsics":
        """Nominal D415 intrinsics scaled to the requested resolution."""
        scale = width / 848.0
        return CameraIntrinsics(
            width=width,
            height=height,
            fx=425.0 * scale,
            fy=425.0 * scale,
            ppx=width / 2.0,
            ppy=height / 2.0,
        )


def rs_projection(f, w, h, ppx, ppy, zmin, zmax) -> np.ndarray:
    """OpenGL-style projection matrix from RealSense intrinsics
    (reference src/util.py:12-19); used by the datagen re-renderer."""
    return np.array(
        [
            [2 * f / w, 0, 0, 0],
            [0, 2 * f / h, 0, 0],
            [2 * (ppx / w) - 1, 2 * (ppy / h) - 1, (zmax + zmin) / (zmax - zmin), 1],
            [0, 0, 2 * zmax * zmin / (zmin - zmax), 0],
        ],
        dtype=np.float32,
    ).T
