"""Where the port builds its kernels: the counterpart of the JAX package's
``utils/compile_cache.py`` (its persistent XLA cache).

The port's CUDA kernels (``ops/cuda_lib.py``) and its host grouping library
(``native/grouping.py``) are compiled at first use into one directory:

* in a checkout of this repository (the package's parent holds the
  project's ``pyproject.toml``): ``build/beats3d_tpu_torch/`` at its root,
  which git ignores;
* in an installed copy: ``$BEATS3D_COMPILE_CACHE/beats3d_tpu_torch`` when
  that variable is set, else ``~/.cache/beats3d_tpu_torch``, as the JAX
  package keeps its XLA cache.

Each library's name carries a hash of its sources and flags, so an upgraded
install builds anew and several versions share the directory.  The two
modules read the directory once, when they are imported.
"""

from __future__ import annotations

import os
from typing import Optional

PROJECT = "beats3d-tpu"
PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def checkout_root() -> Optional[str]:
    """The repository's root when the package runs from a checkout (its
    parent directory holds the ``pyproject.toml`` of project ``PROJECT``),
    else None."""
    import tomllib

    root = os.path.dirname(PKG_DIR)
    try:
        with open(os.path.join(root, "pyproject.toml"), "rb") as f:
            meta = tomllib.load(f)
    except FileNotFoundError:
        return None
    return root if meta.get("project", {}).get("name") == PROJECT else None


def kernel_build_dir() -> str:
    """The directory the port's kernels are built into (module docstring)."""
    root = checkout_root()
    if root is not None:
        return os.path.join(root, "build", "beats3d_tpu_torch")
    cache = os.environ.get("BEATS3D_COMPILE_CACHE") or os.path.join(
        os.path.expanduser("~"), ".cache")
    return os.path.join(cache, "beats3d_tpu_torch")
