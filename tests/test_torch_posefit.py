"""The port's pose fit (beats3d_tpu_torch.ops.posefit, apps/pose_fit_torch.py)
against the JAX package on the CPU, on the two cases of
tests/test_render.py: the rendered cylinder bit for bit, every iteration's
best cost within rtol 1e-5 (the JAX package sums the cost in float32 in
XLA's order, the port in float64), the same accepted iterations and poses,
and the same orbit-view HTML; then the port's app end to end on the CPU."""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beats3d_tpu.ops import posefit as jposefit
from beats3d_tpu.utils import CameraIntrinsics
from beats3d_tpu_torch.ops import forest_eval_cuda, posefit

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_app(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "apps", f"{name}.py"))
    app = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(app)
    return app


def _scene(w=106, h=60):
    """The observed cylinder of tests/test_render.py and its labels."""
    intrin = CameraIntrinsics.d415(w, h)
    true = posefit.CylinderTform()
    true.t[:] = [0.0, 0.0, -400.0]
    true.s[:] = [150.0, 150.0, 600.0]
    plane_mat = np.eye(4, dtype=np.float32)
    plane_mat[2, 3] = -2000.0
    obj = (np.linalg.inv(plane_mat) @ true.get_tform()).astype(np.float32)
    surface = posefit.cylinder_surface(64, 64)
    want = np.asarray(jposefit.render_cylinder_depth(
        jnp.asarray(surface), jnp.asarray(obj), jnp.asarray(intrin.pp),
        jnp.float32(intrin.fx), jnp.zeros((h, w), jnp.uint16)))
    obs = posefit.render_cylinder_depth(torch.as_tensor(surface), obj,
                                        intrin.pp, intrin.fx, (h, w))
    assert obs.dtype == torch.uint16
    np.testing.assert_array_equal(obs.numpy(), want)
    init = true.copy()
    init.t[0] += 60.0
    return intrin, want, (want > 0).astype(np.uint16), plane_mat, init


def _fit_both(iterations, seed=0, w=106, h=60, n_samples=64):
    intrin, obs, labels, plane_mat, init = _scene(w, h)
    runs = []
    for mod, kw in ((jposefit, {}), (posefit, {"device": "cpu"})):
        poses = []
        best, cost, history = mod.fit_cylinder(
            obs, labels, plane_mat, init.copy(), intrin.pp, intrin.fx,
            iterations=iterations, rng=np.random.default_rng(seed),
            n_samples=n_samples,
            on_improve=lambda i, c, tf: poses.append((i, c, tf)), **kw)
        runs.append((best, cost, history, poses))
    (jb, jc, jh, jp), (tb, tc, th, tp) = runs
    np.testing.assert_allclose(th, jh, rtol=1e-5)
    assert [i for i, _, _ in tp] == [i for i, _, _ in jp]
    for (_, _, a), (_, _, b) in zip(tp, jp):
        for x, y in ((a.t, b.t), (a.r, b.r), (a.s, b.s)):
            np.testing.assert_array_equal(x, y)
    return runs


@pytest.mark.parametrize("w,h", [(106, 60), (848, 480)])
def test_render_cylinder_matches_jax(w, h):
    _scene(w, h)


def test_fit_cylinder_matches_jax():
    runs = _fit_both(0)
    assert runs[1][1] == pytest.approx(runs[0][1], rel=1e-5)
    c0 = runs[1][1]
    runs = _fit_both(40)
    c1 = runs[1][1]
    assert c1 < 0.8 * c0, (c0, c1)


def test_fit_view_matches_jax(tmp_path):
    (_, _, _, jposes), (_, _, _, tposes) = _fit_both(40)
    _, obs, labels, _, _ = _scene()
    qf = np.zeros((60, 106, 4), np.float32)
    qf[..., 2] = obs
    _load_app("pose_fit").write_fit_view(str(tmp_path / "jax.html"), qf,
                                         labels, 1, jposes)
    _load_app("pose_fit_torch").write_fit_view(str(tmp_path / "port.html"),
                                               qf, labels, 1, tposes)
    want = (tmp_path / "jax.html").read_text()
    got = (tmp_path / "port.html").read_text()
    if got != want:
        # the info line carries the final cost (rtol 1e-5)
        strip = [l for l in got.splitlines() if "poses (final green)" not in l]
        assert strip == [l for l in want.splitlines()
                         if "poses (final green)" not in l]
    assert "orbit" in got and "#37e06b" in got


def test_pose_fit_app_runs_on_cpu(tmp_path):
    """apps/pose_fit_torch.py on the synthetic source at 424x240 with the
    flagship's coarse layer, on the CPU (B1's plain version: no launch)."""
    before = forest_eval_cuda.evaluate_forest_cuda.launches
    best, cost, history, poses = _load_app("pose_fit_torch").run([
        "-m", os.path.join(ROOT, "models", "flagship", "m0.npy"),
        "--synthetic", "--rs_half_resolution", "--plane_z_threshold", "40",
        "--plane_num_iterations", "256", "--iterations", "8", "--seed", "0",
        "--device", "cpu", "--view", str(tmp_path / "fit.html")])
    assert forest_eval_cuda.evaluate_forest_cuda.launches == before
    assert len(history) == 9 and np.isfinite(cost) and cost == history[-1]
    assert cost <= history[0] and poses[0][0] == 0
    assert "pose_fit" in (tmp_path / "fit.html").read_text()
