"""Host BFS grouping, the counterpart of beats3d_tpu/native/grouping.py
(the reference's src/cpp_grouping/: C++ BFS + Cython wrapper,
cpp_grouping.pyx:7-23): the parity oracle of the device path
``ops.components.make_hand_groups``.

``grouping.cpp`` beside this file is compiled by the host C++ compiler
(``$CXX``, else ``c++`` / ``g++``) at first use into
``utils.compile_cache.kernel_build_dir()``, under a name that carries a hash
of the source and the command, and bound with ``ctypes``.  A missing source
or a failed build raises; nothing falls back.  ``_make_groups_py`` is the
plain version the tests hold the library to.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import List, Optional, Tuple

import numpy as np

from ..utils.compile_cache import kernel_build_dir

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "grouping.cpp")
BUILD_DIR = kernel_build_dir()
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-shared")


@dataclasses.dataclass
class Build:
    path: str
    command: List[str]  # the compiler line (the output at its temporary name)
    seconds: float      # compiler wall time; 0.0 when a build was reused


def _cxx() -> str:
    for c in (os.environ.get("CXX"), "c++", "g++"):
        found = c and shutil.which(c)
        if found:
            return found
    raise RuntimeError("no C++ compiler found ($CXX, c++, g++): the native "
                       "grouping library cannot be built")


def compile_library() -> Build:
    """Build (or reuse) the shared library; raise if the source is missing
    or the compiler fails."""
    if not os.path.isfile(SOURCE):
        raise RuntimeError(
            f"{SOURCE} is missing: this install of beats3d_tpu_torch lacks "
            "its native grouping source (build the wheel with python -m "
            "beats3d_tpu_torch.release)")
    cxx = _cxx()
    with open(SOURCE, "rb") as f:
        src = f.read()
    h = hashlib.sha256(" ".join((os.path.basename(cxx),) + CXX_FLAGS).encode()
                       + b"\0" + src)
    path = os.path.join(BUILD_DIR,
                        f"libbeats3d_grouping_{h.hexdigest()[:16]}.so")
    tmp = f"{path}.{os.getpid()}.tmp"
    command = [cxx, *CXX_FLAGS, "-o", tmp, SOURCE]
    if os.path.exists(path):
        return Build(path, command, 0.0)
    os.makedirs(BUILD_DIR, exist_ok=True)
    t0 = time.perf_counter()
    proc = subprocess.run(command, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"native grouping build failed ({proc.returncode})"
                           f": {' '.join(command)}\n{proc.stdout}"
                           f"{proc.stderr}")
    os.replace(tmp, path)
    return Build(path, command, time.perf_counter() - t0)


class _Library:
    def __init__(self):
        self._lock = threading.Lock()
        self.build: Optional[Build] = None
        self.lib = None

    def get(self):
        with self._lock:
            if self.lib is None:
                self.build = compile_library()
                lib = ctypes.CDLL(self.build.path)
                lib.make_groups.argtypes = [
                    ctypes.POINTER(ctypes.c_uint16), ctypes.c_int,
                    ctypes.c_int, ctypes.POINTER(ctypes.c_uint16),
                    ctypes.POINTER(ctypes.c_float), ctypes.c_float,
                ]
                lib.make_groups.restype = None
                self.lib = lib
            return self.lib


LIBRARY = _Library()


def library():
    """The bound library, built at the first call."""
    return LIBRARY.get()


def make_groups_native(depth: np.ndarray, pct_thresh: float
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Native BFS grouping. depth: (H, W) uint16.
    Returns (groups (H, W) uint16 with 1=right/2=left, g_info (2, 3) f32)."""
    lib = library()
    depth = np.ascontiguousarray(depth, dtype=np.uint16)
    if depth.ndim != 2:
        raise ValueError(f"depth must be (H, W), got {depth.shape}")
    h, w = depth.shape
    groups = np.zeros((h, w), dtype=np.uint16)
    g_info = np.zeros((2, 3), dtype=np.float32)
    lib.make_groups(
        depth.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        ctypes.c_int(h), ctypes.c_int(w),
        groups.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        g_info.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_float(pct_thresh),
    )
    return groups, g_info


def _make_groups_py(depth: np.ndarray, pct_thresh: float):
    """Plain numpy BFS, the same contract (the tests' reference)."""
    h, w = depth.shape
    seen = np.zeros((h, w), dtype=bool)
    best = {0: ([], 0.0, 0.0), 1: ([], 0.0, 0.0)}
    for y0 in range(h):
        for x0 in range(w):
            if seen[y0, x0] or depth[y0, x0] == 0:
                continue
            seen[y0, x0] = True
            queue = [(y0, x0)]
            qi = 0
            sx = sy = 0
            while qi < len(queue):
                y, x = queue[qi]
                qi += 1
                sx += x
                sy += y
                for dy, dx in ((-1, 0), (1, 0), (0, -1), (0, 1)):
                    ny, nx = y + dy, x + dx
                    if 0 <= ny < h and 0 <= nx < w and not seen[ny, nx]:
                        seen[ny, nx] = True
                        if depth[ny, nx]:
                            queue.append((ny, nx))
            if len(queue) / (h * w) <= pct_thresh:
                continue
            cx = sx / len(queue)
            cy = sy / len(queue)
            side = 0 if cx < w / 2.0 else 1
            if len(queue) > len(best[side][0]):
                best[side] = (queue, cx, cy)
    groups = np.zeros((h, w), dtype=np.uint16)
    g_info = np.zeros((2, 3), dtype=np.float32)
    for side in (0, 1):
        comp, cx, cy = best[side]
        for (y, x) in comp:
            groups[y, x] = side + 1
        g_info[side] = (len(comp), cx, cy)
    return groups, g_info


class CppGrouping:
    """Drop-in class mirroring the reference wrapper's call shape
    (cpp_grouping.pyx:13-23)."""

    def make_groups(self, img: np.ndarray, pct_thresh: float):
        return make_groups_native(img, pct_thresh)
