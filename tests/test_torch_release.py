"""The port's release (beats3d_tpu_torch.release): the wheel carries every
kernel source and the 11 ``-torch`` console scripts beside the JAX
package's; an installed copy, run from the unpacked wheel with the bundle's
flagship model, builds into its user cache (``utils.compile_cache``), builds
the native grouping library from its own ``grouping.cpp`` and gives the
checkout's labels on one frame; an install without its sources raises naming
what is missing."""

import ast
import json
import os
import re
import subprocess
import sys
import tarfile
import zipfile

import numpy as np
import pytest

from beats3d_tpu_torch import release
from beats3d_tpu_torch.native import grouping
from beats3d_tpu_torch.ops import cuda_lib
from beats3d_tpu_torch.utils import compile_cache

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "beats3d_tpu_torch")
SOURCES = sorted(
    [os.path.join("csrc", f) for f in os.listdir(os.path.join(PKG, "csrc"))
     if f.endswith((".cu", ".cuh"))]
    + [os.path.join("native", "grouping.cpp")])
# the JAX package's console scripts, as pyproject.toml named them before the
# port: app module -> command
JAX_SCRIPTS = {
    "bz3d": "bz3d", "run_live": "b3d-run-live",
    "run_live_layered": "b3d-run-live-layered",
    "test_on_saved_model": "b3d-test-on-saved-model",
    "train_model": "b3d-train-model",
    "live_data_convert": "b3d-live-data-convert",
    "merge_datasets": "b3d-merge-datasets", "pose_fit": "b3d-pose-fit",
    "pointcloids": "b3d-pointcloids", "stereo_depth": "b3d-stereo-depth",
    "make_proj_image": "b3d-make-proj-image",
}
PLANE_ITERATIONS = 64      # RANSAC guesses: 25,000 take minutes on the CPU

# one 424x240 synthetic frame (the camera's half resolution) of the flagship
# through FramePipeline on the CPU, run by the checkout here and by the
# installed copy in its process; on one thread, so both sum in one order and
# the test workers do not oversubscribe the host's cores
ONE_FRAME = r'''
def one_frame(cfg_path, plane_iterations):
    import numpy as np
    import torch
    from beats3d_tpu_torch.models import LayeredDecisionForest
    from beats3d_tpu_torch.ops import plane, points
    from beats3d_tpu_torch.runtime.camera import SyntheticSource
    from beats3d_tpu_torch.runtime.pipeline import FramePipeline
    from beats3d_tpu_torch.utils.intrinsics import CameraIntrinsics

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        intrin = CameraIntrinsics.d415(424, 240)
        depth = SyntheticSource(intrin).make_frame(0)
        model = LayeredDecisionForest.load(cfg_path, labels_reduce=2,
                                           device="cpu")
        pts = points.deproject_points(
            torch.as_tensor(depth.astype(np.int32)), intrin.pp, intrin.fx)
        mat = plane.CalibratedPlane(plane_iterations, 40.0,
                                    device="cpu").make(pts)
        out = FramePipeline(model, intrin)(depth, mat)
    finally:
        torch.set_num_threads(threads)
    return out["labels"].numpy(), out["heights"].numpy()


def noise_groups(native):
    import numpy as np

    d = (np.random.default_rng(3).random((60, 106)) < 0.5)
    return native(d.astype(np.uint16) * 1000, 0.02)
'''

INSTALLED = ONE_FRAME + r'''
import json, os, sys
import numpy as np
import apps, beats3d_tpu_torch
from beats3d_tpu_torch.native import grouping
from beats3d_tpu_torch.ops import cuda_lib
from beats3d_tpu_torch.utils import compile_cache

out, cfg_path, plane_iterations = sys.argv[1], sys.argv[2], int(sys.argv[3])
labels, heights = one_frame(cfg_path, plane_iterations)
groups, info = noise_groups(grouping.make_groups_native)
build = grouping.LIBRARY.build
np.savez(out, labels=labels, heights=heights, groups=groups, info=info)
report = dict(
    files=[beats3d_tpu_torch.__file__, apps.__file__,
           cuda_lib.__file__, cuda_lib.CSRC_DIR, grouping.SOURCE],
    sys_path=sys.path, checkout_root=compile_cache.checkout_root(),
    build_dirs=[cuda_lib.BUILD_DIR, grouping.BUILD_DIR,
                compile_cache.kernel_build_dir()],
    grouping=dict(path=build.path, source=build.command[-1],
                  seconds=build.seconds))
del os.environ["BEATS3D_COMPILE_CACHE"]
report["build_dir_no_env"] = compile_cache.kernel_build_dir()
print(json.dumps(report))
'''


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    return release.build_release(str(tmp_path_factory.mktemp("dist")))


@pytest.fixture(scope="module")
def wheel_files(built):
    with zipfile.ZipFile(built.wheel) as z:
        return {n: z.read(n) for n in z.namelist()}


def _entry_points(wheel_files):
    name = next(n for n in wheel_files
                if n.endswith(".dist-info/entry_points.txt"))
    text = wheel_files[name].decode()
    assert text.startswith("[console_scripts]\n")
    return [tuple(line.split(" = ")) for line in text.splitlines()[1:]
            if line]


@pytest.fixture(scope="module")
def installed(built, tmp_path_factory):
    """The unpacked wheel run in its own process: cwd outside the checkout,
    PYTHONPATH the install alone, HOME and BEATS3D_COMPILE_CACHE empty."""
    tmp = tmp_path_factory.mktemp("install")
    site, run, cache, home = (tmp / n for n in ("site", "run", "cache",
                                                "home"))
    for d in (run, cache, home):
        d.mkdir()
    with zipfile.ZipFile(built.wheel) as z:
        z.extractall(site)
    with tarfile.open(built.bundle) as tf:
        tf.extractall(tmp / "bundle", filter="data")
    env = dict(os.environ, PYTHONPATH=str(site), HOME=str(home),
               BEATS3D_COMPILE_CACHE=str(cache))
    out = tmp / "out.npz"
    proc = subprocess.run(
        [sys.executable, "-c", INSTALLED, str(out),
         str(tmp / "bundle" / "models" / "flagship" / "model_cfg.json"),
         str(PLANE_ITERATIONS)],
        cwd=run, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    report = json.loads(proc.stdout.splitlines()[-1])
    return dict(site=str(site), cache=str(cache), home=str(home),
                report=report, arrays=dict(np.load(out)))


@pytest.mark.parametrize("rel", SOURCES)
def test_wheel_carries_kernel_source(wheel_files, rel):
    with open(os.path.join(PKG, rel), "rb") as f:
        want = f.read()
    got = wheel_files["beats3d_tpu_torch/" + rel.replace(os.sep, "/")]
    assert got == want


def test_wheel_carries_every_port_module(wheel_files):
    """Every .py of the package and of apps/ is in the wheel, and nothing of
    the port outside them but the kernel sources."""
    want = {os.path.relpath(os.path.join(d, f), ROOT).replace(os.sep, "/")
            for top in ("beats3d_tpu_torch", "apps")
            for d, _, fs in os.walk(os.path.join(ROOT, top))
            for f in fs if f.endswith(".py")}
    got = {n for n in wheel_files
           if n.startswith(("beats3d_tpu_torch/", "apps/"))}
    assert got == want | {"beats3d_tpu_torch/" + r.replace(os.sep, "/")
                          for r in SOURCES}


@pytest.mark.parametrize("module", sorted(JAX_SCRIPTS))
def test_wheel_names_console_scripts(wheel_files, module):
    """The JAX app keeps its command; its port is the same command with
    ``-torch``, named once, at the port's ``main``."""
    entries = _entry_points(wheel_files)
    assert len(entries) == 2 * len(JAX_SCRIPTS)
    command = JAX_SCRIPTS[module]
    assert [e for e in entries if e[1] == f"apps.{module}:main"] == [
        (command, f"apps.{module}:main")]
    assert [e for e in entries if e[1] == f"apps.{module}_torch:main"] == [
        (command + "-torch", f"apps.{module}_torch:main")]


@pytest.mark.parametrize("module", sorted(JAX_SCRIPTS))
def test_console_script_main_returns_nothing(module):
    """A console script exits with what ``main`` returns: the port's
    ``main`` returns no value (results come from ``run``)."""
    path = os.path.join(ROOT, "apps", f"{module}_torch.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    returns = [n for n in ast.walk(main)
               if isinstance(n, ast.Return) and n.value is not None]
    assert not returns, f"{path}: main returns a value"


def test_bundle_holds_wheel_model_and_docs(built):
    with tarfile.open(built.bundle) as tf:
        names = set(tf.getnames())
    assert os.path.basename(built.wheel) in names
    for rel in ("README.md", "COMPONENTS.md",
                "models/flagship/model_cfg.json", "models/flagship/m0.npy",
                "models/flagship/m1.npy.gz"):
        assert rel in names, rel
    assert re.fullmatch(r"beats3d-tpu-torch-[0-9.]+-bundle\.tar\.gz",
                        os.path.basename(built.bundle))


def test_checkout_builds_into_its_build_dir(monkeypatch):
    want = os.path.join(ROOT, "build", "beats3d_tpu_torch")
    monkeypatch.setenv("BEATS3D_COMPILE_CACHE", "/nonexistent")
    assert compile_cache.checkout_root() == ROOT
    assert compile_cache.kernel_build_dir() == want
    assert cuda_lib.BUILD_DIR == grouping.BUILD_DIR == want


def test_installed_copy_imports_from_the_install(installed):
    site = installed["site"] + os.sep
    report = installed["report"]
    for path in report["files"]:
        assert path.startswith(site), path
    assert ROOT not in report["sys_path"]
    assert report["checkout_root"] is None


def test_installed_copy_builds_into_user_cache(installed):
    report = installed["report"]
    cache_dir = os.path.join(installed["cache"], "beats3d_tpu_torch")
    assert report["build_dirs"] == [cache_dir] * 3
    assert report["build_dir_no_env"] == os.path.join(
        installed["home"], ".cache", "beats3d_tpu_torch")


def test_installed_cpu_frame_equals_checkout(installed):
    exec_ns = {}
    exec(ONE_FRAME, exec_ns)
    labels, heights = exec_ns["one_frame"](
        os.path.join(ROOT, "models", "flagship", "model_cfg.json"),
        PLANE_ITERATIONS)
    got = installed["arrays"]
    assert (labels > 0).any()
    np.testing.assert_array_equal(got["labels"], labels)
    np.testing.assert_array_equal(got["heights"], heights)


def test_installed_native_grouping_builds_from_install(installed):
    built = installed["report"]["grouping"]
    assert built["source"] == os.path.join(
        installed["site"], "beats3d_tpu_torch", "native", "grouping.cpp")
    assert os.path.dirname(built["path"]) == os.path.join(
        installed["cache"], "beats3d_tpu_torch")
    assert os.path.isfile(built["path"]) and built["seconds"] > 0
    exec_ns = {}
    exec(ONE_FRAME, exec_ns)
    groups, info = exec_ns["noise_groups"](grouping.make_groups_native)
    np.testing.assert_array_equal(installed["arrays"]["groups"], groups)
    np.testing.assert_array_equal(installed["arrays"]["info"], info)


def test_missing_kernel_sources_raise_before_nvcc(tmp_path, monkeypatch):
    empty = tmp_path / "csrc"
    empty.mkdir()

    def no_nvcc():
        raise AssertionError("nvcc reached with no sources")

    monkeypatch.setattr(cuda_lib, "CSRC_DIR", str(empty))
    monkeypatch.setattr(cuda_lib, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(cuda_lib, "_nvcc", no_nvcc)
    with pytest.raises(RuntimeError, match=re.escape(str(empty))) as err:
        cuda_lib._compile()
    assert "lacks its kernel sources" in str(err.value)
    assert not (tmp_path / "build").exists()


def test_missing_grouping_source_raises(tmp_path, monkeypatch):
    missing = tmp_path / "grouping.cpp"

    def no_cxx():
        raise AssertionError("compiler looked up with no source")

    monkeypatch.setattr(grouping, "SOURCE", str(missing))
    monkeypatch.setattr(grouping, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(grouping, "_cxx", no_cxx)
    with pytest.raises(RuntimeError, match=re.escape(str(missing))) as err:
        grouping.compile_library()
    assert "lacks its native grouping source" in str(err.value)
