"""Build the port's release from a checkout: the project's wheel, which
carries the port's kernel sources and console scripts, and a bundle with the
flagship model and the docs (the port's counterpart of the JAX package's
``scripts/make_release.py``).

    python -m beats3d_tpu_torch.release [--out dist]

Writes into ``--out``:

* ``beats3d_tpu-<ver>-py3-none-any.whl``: both packages, ``apps`` and
  their console scripts (``bz3d-torch`` and the other ``-torch`` commands),
  with ``beats3d_tpu_torch/csrc/*.cu``, ``*.cuh`` and
  ``native/grouping.cpp``.  An installed copy builds its kernels from them
  at first use into its user cache (``utils.compile_cache``).
* ``beats3d-tpu-torch-<ver>-bundle.tar.gz``: the wheel, ``README.md``,
  ``COMPONENTS.md`` and ``models/flagship/``.

The wheel is built by ``pip wheel --no-deps --no-build-isolation`` with the
host's setuptools from a copy of the project staged in a temporary
directory: built in place, setuptools would write ``build/lib``,
``build/bdist.*`` and an ``.egg-info`` into the checkout, whose ``build/``
holds the kernel cache.
"""

from __future__ import annotations

import argparse
import dataclasses
import fnmatch
import os
import shutil
import subprocess
import sys
import tarfile
import tempfile
import tomllib

from .utils.compile_cache import checkout_root

BUNDLE_FILES = ("README.md", "COMPONENTS.md", "models/flagship")


@dataclasses.dataclass
class Release:
    wheel: str
    bundle: str


def _stage(root: str, stage: str, meta: dict) -> None:
    """Copy what the wheel is built from: ``pyproject.toml``, its readme
    and the top-level packages its ``packages.find`` includes."""
    readme = meta["project"]["readme"]
    for name in ("pyproject.toml", readme):
        shutil.copy2(os.path.join(root, name), os.path.join(stage, name))
    include = meta["tool"]["setuptools"]["packages"]["find"]["include"]
    skip = shutil.ignore_patterns("__pycache__", "*.pyc")
    for name in sorted(os.listdir(root)):
        path = os.path.join(root, name)
        if (os.path.isfile(os.path.join(path, "__init__.py"))
                and any(fnmatch.fnmatch(name, pat) for pat in include)):
            shutil.copytree(path, os.path.join(stage, name), ignore=skip)


def build_release(out: str) -> Release:
    """Build the wheel and the bundle into ``out``; raise outside a checkout
    or if pip fails."""
    root = checkout_root()
    if root is None:
        raise RuntimeError("beats3d_tpu_torch.release builds from a checkout "
                           "of the repository; this copy is installed")
    with open(os.path.join(root, "pyproject.toml"), "rb") as f:
        meta = tomllib.load(f)
    version = meta["project"]["version"]
    out = os.path.abspath(out)
    os.makedirs(out, exist_ok=True)
    wheel = os.path.join(
        out, f"{meta['project']['name'].replace('-', '_')}-{version}"
        "-py3-none-any.whl")
    with tempfile.TemporaryDirectory() as stage:
        _stage(root, stage, meta)
        proc = subprocess.run(
            [sys.executable, "-m", "pip", "wheel", "--no-deps",
             "--no-build-isolation", "--no-index",
             "--disable-pip-version-check", "--no-cache-dir", "-q", "-w",
             out, stage],
            capture_output=True, text=True)
    if proc.returncode != 0 or not os.path.isfile(wheel):
        raise RuntimeError(f"pip wheel failed ({proc.returncode}), "
                           f"expected {wheel}:\n{proc.stdout}{proc.stderr}")
    bundle = os.path.join(out, f"beats3d-tpu-torch-{version}-bundle.tar.gz")
    with tarfile.open(bundle, "w:gz") as tf:
        tf.add(wheel, arcname=os.path.basename(wheel))
        for rel in BUNDLE_FILES:
            tf.add(os.path.join(root, rel), arcname=rel)
    return Release(wheel, bundle)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="dist",
                    help="directory for the wheel and the bundle")
    rel = build_release(ap.parse_args(argv).out)
    print(f"release: {rel.wheel}")
    print(f"release: {rel.bundle}")


if __name__ == "__main__":
    main()
