# Copied from beats3d_tpu/utils/transforms.py (numpy only).
"""4x4 transform helpers (reference src/engine/glm_np.py:1-22 equivalents,
pure numpy, standard row-major math convention: M @ [x, y, z, 1])."""

from __future__ import annotations

import numpy as np


def translate(v) -> np.ndarray:
    m = np.eye(4, dtype=np.float32)
    m[:3, 3] = v
    return m


def scale(v) -> np.ndarray:
    m = np.eye(4, dtype=np.float32)
    m[0, 0], m[1, 1], m[2, 2] = v
    return m


def rotate_x(a: float) -> np.ndarray:
    c, s = np.cos(a), np.sin(a)
    m = np.eye(4, dtype=np.float32)
    m[1, 1], m[1, 2], m[2, 1], m[2, 2] = c, -s, s, c
    return m


def rotate_y(a: float) -> np.ndarray:
    c, s = np.cos(a), np.sin(a)
    m = np.eye(4, dtype=np.float32)
    m[0, 0], m[0, 2], m[2, 0], m[2, 2] = c, s, -s, c
    return m


def rotate_z(a: float) -> np.ndarray:
    c, s = np.cos(a), np.sin(a)
    m = np.eye(4, dtype=np.float32)
    m[0, 0], m[0, 1], m[1, 0], m[1, 1] = c, -s, s, c
    return m
