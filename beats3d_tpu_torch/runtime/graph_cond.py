"""``jax.lax.cond`` for the frame programs: only the branch taken runs,
chosen on the device.

    cond(pred, true_fn, false_fn, *operands) -> outputs

``pred`` is a 0-d bool tensor; each branch takes ``operands`` and returns a
tensor or a tuple/list of tensors, the two alike in shapes and dtypes (as
``lax.cond`` requires).  Two forms:

* Eager (the CPU, a frame graph's warm-up, a frame program called
  directly): both branches run and ``torch.where`` selects, so no value is
  read back to the host.  This warms up both bodies before a capture and is
  the reference a captured graph is held to, bit for bit.
* Capture (inside :func:`graph`, on CUDA): the graph gets a conditional node
  per branch (``csrc/graph_cond.cu``).  One launch of a one-thread kernel
  reads ``pred`` at each replay and sets the nodes, so exactly one body
  runs.  Each body is captured on a stream of its own and copies its
  results into the cond's outputs: buffers allocated while the first body
  is captured (an allocation launches nothing), before anything after the
  cond is captured.  Conds nest.

:func:`graph` opens the capture (``torch.cuda.graph`` and what the bodies
need): it routes the capture's allocations, the bodies' among them, to a
pool its :class:`Capture` holds, gives the bodies their streams, and reports the launches of the given kernel
wrappers per body and, on the card, the replays of each body.

Conditional nodes set from the device need CUDA 12.4 in the toolkit that
builds ``csrc/`` and in the driver; :func:`require_support` raises naming
the versions where they are older.  No path falls back to running both
branches on the card.
"""

from __future__ import annotations

import contextlib
import ctypes
import threading
from typing import Dict, Sequence, Tuple

import torch

from ..ops import cuda_lib

MIN_CUDA = 12040            # 12.4, as 1000 * major + 10 * minor
CONDS_PER_GRAPH = 8         # the body-replay counters a graph holds

# The capture that cond() records into, per thread (as PyTorch keeps the
# current stream): set by graph() for the length of its capture.
_active = threading.local()


def _version(v: int) -> str:
    return f"{v // 1000}.{v % 1000 // 10}"


_support_checked = set()


def require_support(device) -> None:
    """Raise unless conditional graph nodes work on ``device``'s card: the
    kernels' CUDA toolkit and the driver at 12.4 or later, and PyTorch's
    allocator able to route allocations to a pool of the caller's."""
    device = torch.device(device)
    if device.index in _support_checked:
        return
    lib = cuda_lib.library()
    runtime, driver = ctypes.c_int(), ctypes.c_int()
    cuda_lib.check(lib.b3d_cuda_versions(ctypes.byref(runtime),
                                         ctypes.byref(driver)),
                   "cudaDriverGetVersion")
    routes = hasattr(torch.cuda, "use_mem_pool")
    if runtime.value < MIN_CUDA or driver.value < MIN_CUDA or not routes:
        raise RuntimeError(
            "the frame programs' conditional CUDA graph nodes need CUDA "
            f"{_version(MIN_CUDA)} or later and torch.cuda.use_mem_pool: "
            f"torch {torch.__version__} (built for CUDA "
            f"{torch.version.cuda}, use_mem_pool "
            f"{'present' if routes else 'absent'}), kernels "
            f"built with CUDA {_version(runtime.value)}, driver CUDA "
            f"{_version(driver.value)}")
    _support_checked.add(device.index)


def _flatten(res):
    if isinstance(res, torch.Tensor):
        return [res], lambda outs: outs[0]
    if isinstance(res, (tuple, list)) and all(
            isinstance(t, torch.Tensor) for t in res):
        return list(res), type(res)
    raise TypeError("a cond branch returns a tensor or a tuple/list of "
                    f"tensors, not {type(res).__name__}")


def _check_alike(a: Sequence[torch.Tensor], b: Sequence[torch.Tensor]):
    if len(a) != len(b) or any(x.shape != y.shape or x.dtype != y.dtype
                               for x, y in zip(a, b)):
        raise ValueError(
            "cond branches return different outputs: "
            f"{[(tuple(x.shape), x.dtype) for x in a]} and "
            f"{[(tuple(y.shape), y.dtype) for y in b]}")


def cond(pred: torch.Tensor, true_fn, false_fn, *operands):
    """``true_fn(*operands)`` where ``pred`` holds, else
    ``false_fn(*operands)``; see the module docstring for the two forms."""
    if pred.dtype != torch.bool or pred.dim() != 0:
        raise ValueError(f"cond: pred must be a 0-d bool tensor, got "
                         f"{pred.dtype} of shape {tuple(pred.shape)}")
    if pred.is_cuda and torch.cuda.is_current_stream_capturing():
        capture = getattr(_active, "capture", None)
        if capture is None:
            raise RuntimeError("cond under a CUDA graph capture needs "
                               "graph_cond.graph() around the capture")
        return capture.cond(pred, true_fn, false_fn, operands)
    t, rebuild = _flatten(true_fn(*operands))
    f, _ = _flatten(false_fn(*operands))
    _check_alike(t, f)
    return rebuild([torch.where(pred, a, b) for a, b in zip(t, f)])


class Capture:
    """One capture's conditional bodies.  After the capture:

    ``launches``: {body: {wrapper name: launches}} of the wrappers given to
    :func:`graph`, the body ``""`` being the graph outside every cond and a
    cond's bodies named by their functions, nested ones by their path
    (``"crop_then_rescue/rescue"``).  ``bodies``: {body: (cond, branch)},
    the row and column of ``taken`` that counts the body's replays on the
    card (branch 0 true, 1 false).  ``pool``: the memory pool of the
    capture's allocations (the bodies' among them), which the graph reads
    and writes at each replay: keep it as long as the graph."""

    def __init__(self, device, counters: Sequence):
        self.device = device
        self.counters = tuple(counters)
        self.launches: Dict[str, Dict[str, int]] = {}
        self.bodies: Dict[str, Tuple[int, int]] = {}
        self.taken = torch.zeros(CONDS_PER_GRAPH, 2, dtype=torch.int64,
                                 device=device)
        self.pool = torch.cuda.MemPool()
        self._path = []
        self._conds = 0
        self._streams = []
        self._stream(1)     # a cond's bodies and a nested cond's, made now
        self._mark = self._counts()

    def _counts(self):
        return [k.launches for k in self.counters]

    def _switch(self, path):
        """Credit the wrappers' launches since the last switch to the body
        being captured, then make ``path`` that body."""
        now = self._counts()
        row = self.launches.setdefault("/".join(self._path), {
            k.__name__: 0 for k in self.counters})
        for k, a, b in zip(self.counters, now, self._mark):
            row[k.__name__] += a - b
        self._mark = now
        self._path = path

    def _stream(self, depth):
        while len(self._streams) <= depth:
            handle = ctypes.c_void_p()
            cuda_lib.check(cuda_lib.library().b3d_stream_create(
                ctypes.byref(handle)), "cudaStreamCreate")
            self._streams.append(torch.cuda.ExternalStream(
                handle.value, device=self.device))
        return self._streams[depth]

    def close(self):
        """Credit the last launches and destroy the bodies' streams."""
        self._switch([])
        lib = cuda_lib.library()
        for s in self._streams:
            cuda_lib.check(lib.b3d_stream_destroy(s.cuda_stream),
                           "cudaStreamDestroy")
        self._streams = []

    def cond(self, pred, true_fn, false_fn, operands):
        lib = cuda_lib.library()
        slot = self._conds
        self._conds += 1
        if slot >= CONDS_PER_GRAPH:
            raise RuntimeError(f"more than {CONDS_PER_GRAPH} conds in one "
                               "captured graph")
        bodies = (ctypes.c_void_p * 2)()
        cuda_lib.check(lib.b3d_cond_begin(
            torch.cuda.current_stream().cuda_stream, pred.data_ptr(),
            self.taken[slot].data_ptr(), bodies), "conditional graph node")
        stream = self._stream(len(self._path))
        parent, outs, rebuild = list(self._path), None, None
        for branch, (fn, body) in enumerate(zip((true_fn, false_fn), bodies)):
            path = parent + [fn.__name__]
            name = "/".join(path)
            if name in self.bodies:
                raise ValueError(f"two cond bodies named {name!r}")
            self.bodies[name] = (slot, branch)
            cuda_lib.check(lib.b3d_capture_to_graph(stream.cuda_stream, body),
                           "capture to a conditional body")
            self._switch(path)
            try:
                with torch.cuda.stream(stream):
                    res, rebuild = _flatten(fn(*operands))
                    if outs is None:
                        outs = [torch.empty(t.shape, dtype=t.dtype,
                                            device=t.device) for t in res]
                    _check_alike(outs, res)
                    for o, t in zip(outs, res):
                        o.copy_(t)
            finally:
                self._switch(parent)
                cuda_lib.check(lib.b3d_capture_end(stream.cuda_stream),
                               "end of a conditional body's capture")
        return rebuild(outs)


@contextlib.contextmanager
def graph(cuda_graph: torch.cuda.CUDAGraph, counters: Sequence = (), **kw):
    """``torch.cuda.graph(cuda_graph, **kw)`` in which :func:`cond` makes
    conditional nodes; yields the :class:`Capture`.  ``counters``: kernel
    wrappers with a ``launches`` count, credited per body."""
    device = torch.device("cuda", torch.cuda.current_device())
    require_support(device)
    capture = Capture(device, counters)
    try:
        # the bodies allocate on streams of their own, which the graph's
        # own pool does not route (it routes the capture stream and cannot
        # take a second route): this thread's allocations go to the
        # capture's pool for the length of the capture
        with torch.cuda.graph(cuda_graph, **kw), \
                torch.cuda.use_mem_pool(capture.pool, device):
            _active.capture = capture
            try:
                yield capture
            finally:
                _active.capture = None
    finally:
        capture.close()
