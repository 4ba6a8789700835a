"""Build and load the port's hand-written CUDA kernels.

``csrc/*.cu`` are compiled by ``nvcc`` at first use, one ``nvcc`` process per
source, all started together, and linked into one shared library with a
plain C interface in ``build/beats3d_tpu_torch/`` beside the package, bound
with ``ctypes``.  The library's name carries a hash of
the sources and flags, so an edited source is rebuilt and a stale build is
never loaded.  Nothing here runs at import time: the CPU tests import every
module on hosts without ``nvcc``.

Flags: ``sm_90a`` (Hopper); ``--fmad=false`` and ``-prec-div=true`` because
probe offsets and the plane-band test sit on integer and threshold
boundaries, where a contracted multiply-add or an approximate division moves
results (the kernels also spell the arithmetic with ``__fmul_rn`` /
``__fdiv_rn`` and their quotient's two fused multiply-adds with
``__fmaf_rn``).  Never ``--use_fast_math``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import glob
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
import time
from typing import Optional

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PKG_DIR), "build", "beats3d_tpu_torch")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "--fmad=false", "-prec-div=true",
    "-prec-sqrt=true", "-Xptxas", "-v",
)


class LayerDesc(ctypes.Structure):
    """Mirror of ``B3dLayerDesc`` in csrc/forest_eval.cu."""

    _fields_ = [
        ("header", ctypes.c_void_p),
        ("pdf", ctypes.c_void_p),
        ("trees", ctypes.c_int),
        ("levels", ctypes.c_int),
        ("classes", ctypes.c_int),
        ("filter_model", ctypes.c_int),
        ("filter_class", ctypes.c_int),
    ]


@dataclasses.dataclass
class Build:
    path: str
    seconds: float      # nvcc wall time; 0.0 when an existing build was reused
    log: str            # nvcc / ptxas output (registers, shared memory,
                        # spills), kept beside the library


def _sources():
    return sorted(
        glob.glob(os.path.join(CSRC_DIR, "*.cu"))
        + glob.glob(os.path.join(CSRC_DIR, "*.cuh"))
    )


def _nvcc() -> str:
    cands = [shutil.which("nvcc")]
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if cuda_home:
        cands.append(os.path.join(cuda_home, "bin", "nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


class _Library:
    def __init__(self):
        self._lock = threading.Lock()
        self.build: Optional[Build] = None
        self.lib = None

    def get(self):
        with self._lock:
            if self.lib is None:
                self.build = _compile()
                self.lib = _bind(ctypes.CDLL(self.build.path))
            return self.lib


def _compile() -> Build:
    srcs = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs:
        with open(s, "rb") as f:
            h.update(os.path.basename(s).encode() + b"\0" + f.read())
    path = os.path.join(BUILD_DIR, f"libbeats3d_kernels_{h.hexdigest()[:16]}.so")
    if os.path.exists(path):
        log = ""
        if os.path.exists(path + ".log"):
            with open(path + ".log") as f:
                log = f.read()
        return Build(path, 0.0, log)
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as objdir:
        jobs = []
        for src in (s for s in srcs if s.endswith(".cu")):
            obj = os.path.join(objdir, os.path.basename(src) + ".o")
            jobs.append((obj, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", "-o", obj, src],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        log, failed = "", []
        for obj, proc in jobs:
            log += proc.communicate()[0]
            if proc.returncode != 0:
                failed.append(os.path.basename(obj))
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
        proc = subprocess.run(
            [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", tmp,
             *[obj for obj, _ in jobs]],
            capture_output=True, text=True)
        log += proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{log}")
    seconds = time.perf_counter() - t0
    with open(f"{path}.{os.getpid()}.log", "w") as f:
        f.write(log)
    os.replace(f"{path}.{os.getpid()}.log", path + ".log")
    os.replace(tmp, path)
    return Build(path, seconds, log)


def _bind(lib):
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.b3d_evaluate_layered.argtypes = [
        vp, vp, i, i, i, i, f, ctypes.POINTER(LayerDesc), i, vp, i, i, vp,
    ]
    lib.b3d_evaluate_layered.restype = i
    lib.b3d_plane_band_gauss.argtypes = [
        vp, vp, i, i, i, vp, f, f, f, f, ctypes.POINTER(ctypes.c_float), vp,
    ]
    lib.b3d_plane_band_gauss.restype = i
    lib.b3d_evaluate_forest.argtypes = [
        vp, vp, i, i, i, i, f, vp, i, i, i, vp, i, i, i, vp,
    ]
    lib.b3d_evaluate_forest.restype = i
    lib.b3d_train_feature_bits.argtypes = [vp, vp, i, vp, vp, i, i, i, vp]
    lib.b3d_train_feature_bits.restype = i
    # the scripts/ probes (beats3d_tpu_torch/probes): pointers, ints, stream
    for name, n_ptrs, n_ints in (
            ("b3d_probe_opcost", 3, 3), ("b3d_probe_reduce", 2, 3),
            ("b3d_probe_loopcost", 2, 3), ("b3d_probe_loopcost2", 2, 4),
            ("b3d_probe_batchmin", 2, 3), ("b3d_probe_axis0", 3, 3),
            ("b3d_probe_vgather_run", 3, 2), ("b3d_probe_vgather8", 3, 0),
            ("b3d_probe_vgather16", 3, 0), ("b3d_probe_prim", 4, 3),
            ("b3d_probe_roll24", 3, 1), ("b3d_probe_dyngrid", 4, 2)):
        fn = getattr(lib, name)
        fn.argtypes = [vp] * n_ptrs + [i] * n_ints + [vp]
        fn.restype = i
    lib.b3d_error_string.argtypes = [i]
    lib.b3d_error_string.restype = ctypes.c_char_p
    return lib


def ptxas_summary(log: str):
    """Per kernel, from nvcc's ``-Xptxas -v`` log: registers, shared memory
    (static bytes), stack frame and spill bytes.  Names are demangled with
    ``c++filt`` where the host has it."""
    rows, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            cur = dict(kernel=m.group(1))
            rows.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores", line)
        if m:
            cur.update(stack=int(m.group(1)), spill=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            cur["smem"] = int(sm.group(1)) if sm else 0
    filt = shutil.which("c++filt")
    if filt and rows:
        names = subprocess.run([filt], input="\n".join(r["kernel"] for r in rows),
                               capture_output=True, text=True).stdout.splitlines()
        if len(names) == len(rows):
            for r, n in zip(rows, names):
                n = n.replace("(anonymous namespace)::", "")
                r["kernel"] = re.sub(r"^void |\(.*", "", n)
    return rows


LIBRARY = _Library()


def library():
    """The loaded kernel library, compiled on first use."""
    return LIBRARY.get()


def check(status: int, what: str):
    """Raise on a non-zero cudaError_t returned by a C entry."""
    if status != 0:
        msg = LIBRARY.lib.b3d_error_string(status).decode()
        raise RuntimeError(f"{what}: CUDA error {status} ({msg})")
