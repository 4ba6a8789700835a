"""The port's datagen (beats3d_tpu_torch.data.datagen) against the JAX
package's on the CPU, on the cases of tests/test_datagen.py (palette
recovery, end to end, the timestamp gate, the gaussian path) and on a
212x120 case with a mask model: the written PNGs and config.json are
byte-equal, and so are frame_count and frames_skipped.

Both converters draw from numpy generators of the same seed.  The RANSAC
stream is the one place where the frameworks draw differently (ROADMAP
C-w5): the port's converter gets a CalibratedPlane fed the JAX plane's
uniforms.  Two steps may differ by design, and each case triages them
first: the plane-space centroid (C-w10: the JAX package sums it in float32
in XLA's order, the port in float64), which steers every augmented frame
from frame 3 on, and the 15x15 gaussian (C-w4: +-1 against XLA's
convolution on exact ties).  Where either differs, the raw datasets may
differ in a stated share of their pixels, and with the JAX centroids and
gaussian injected they must be byte-equal."""

import filecmp
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beats3d_tpu.data import datagen as jdatagen
from beats3d_tpu.models import DecisionForest as JaxForest
from beats3d_tpu.ops import points as jpoints
from beats3d_tpu.utils import CameraIntrinsics
from beats3d_tpu_torch.data import datagen
from beats3d_tpu_torch.models import DecisionForest
from beats3d_tpu_torch.ops import plane
from beats3d_tpu_torch.ops import points as tpoints

from test_datagen import _colored_scene

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MASK_MODEL = os.path.join(ROOT, "models", "flagship", "m0.npy")


class JaxStreamPlane(plane.CalibratedPlane):
    """The port's CalibratedPlane on the CPU, drawing its candidates'
    uniforms from the JAX CalibratedPlane's key stream (split per call)."""

    def __init__(self, num_random_guesses, threshold, seed=0):
        super().__init__(num_random_guesses, threshold, device="cpu")
        self._key = jax.random.PRNGKey(seed)

    def make(self, pts, start_mat=None):
        self._key, sub = jax.random.split(self._key)
        u = np.array(jax.random.uniform(
            sub, (self.num_random_guesses, 32), dtype=jnp.float32))
        self.plane = plane.calibrate_plane(
            torch.as_tensor(u), pts, float(self.plane_z_outlier_threshold),
            start_mat=start_mat)
        return self.plane


def _record_centroids(monkeypatch, module, to_numpy, inject=None):
    """Record the centroid of every ``_prep_frame`` call of ``module``;
    with ``inject``, return those centroids in its place."""
    seen = []
    orig = module._prep_frame

    def prep(*args):
        qf, center = orig(*args)
        seen.append(to_numpy(center))
        if inject is not None:
            center = torch.as_tensor(inject[len(seen) - 1])
        return qf, center

    monkeypatch.setattr(module, "_prep_frame", prep)
    return seen


def _tree_files(path):
    return sorted(os.listdir(path))


def _gaussian_against_jax(monkeypatch, use_jax):
    """Wrap the port's gaussian_depth_filter: each call also runs the JAX
    package's (its XLA convolution) on the same input, holds the two to
    C-w4 (at most 1 apart, on exact ties) and records the pixels that
    differ; ``use_jax`` returns the JAX result in place of the port's."""
    differ = []
    orig = tpoints.gaussian_depth_filter

    def gauss(depth, kernel):
        got = orig(depth, kernel)
        want = torch.as_tensor(np.asarray(jpoints.gaussian_depth_filter(
            jnp.asarray(depth.cpu().numpy().astype(np.uint16)),
            jnp.asarray(kernel))).astype(np.int32))
        assert int((got - want).abs().max()) <= 1
        differ.append(int((got != want).sum()))
        return want if use_jax else got

    monkeypatch.setattr(tpoints, "gaussian_depth_filter", gauss)
    return differ


def _run_both(out, intrin, cfg, frames, seed, mask=None, inject=None):
    """Feed ``frames`` ((depth, colour, depth_ts, colour_ts) tuples) through
    both converters, writing to ``out``/jax and ``out``/port.  Returns the
    JAX and the port centroids per frame and the pixels per smoothed frame
    where the two gaussians differ.  ``inject``: centroids the port uses in
    place of its own, and then the JAX gaussian too."""
    with pytest.MonkeyPatch.context() as mp:
        j_cent = _record_centroids(mp, jdatagen, np.asarray)
        t_cent = _record_centroids(mp, datagen, lambda c: c.cpu().numpy(),
                                   inject)
        gauss_differ = _gaussian_against_jax(mp, inject is not None)
        jconv = jdatagen.LiveDataConvert(
            str(out / "jax"), intrin, cfg,
            mask_model=None if mask is None else JaxForest.load(mask),
            rng=np.random.default_rng(seed), log=lambda *a: None)
        tconv = datagen.LiveDataConvert(
            str(out / "port"), intrin, cfg,
            mask_model=None if mask is None else DecisionForest.load(mask),
            rng=np.random.default_rng(seed), log=lambda *a: None,
            device="cpu")
        tconv.plane = JaxStreamPlane(cfg.plane_candidates,
                                     cfg.plane_z_threshold)
        for depth, color, dts, cts in frames:
            assert jconv.process_frame(depth, color, dts, cts) == \
                tconv.process_frame(depth, color, dts, cts)
        if jconv.palette is not None:
            assert jconv.finish() == tconv.finish()
        assert (jconv.frame_count, jconv.frames_skipped) == \
            (tconv.frame_count, tconv.frames_skipped)
    return np.stack(j_cent), np.stack(t_cent), gauss_differ


def _assert_same_dataset(out):
    a, b = out / "jax", out / "port"
    assert _tree_files(a) == _tree_files(b)
    assert _tree_files(a), "nothing written"
    _, mismatch, errors = filecmp.cmpfiles(a, b, _tree_files(a),
                                           shallow=False)
    assert not mismatch and not errors, mismatch + errors


def _pixel_mismatches(out):
    """Pixels that differ between the two datasets' depth and label
    images, over every frame."""
    from PIL import Image

    n = 0
    for name in _tree_files(out / "jax"):
        if name.endswith(("_depth.png", "_labels.png")):
            a = np.asarray(Image.open(out / "jax" / name))
            b = np.asarray(Image.open(out / "port" / name))
            n += int((a != b).sum())
    return n


# C-w10: the plane-space centroid's float32 sum in XLA's order against the
# port's float64 sum, in plane units (depth units, 0.1 mm)
CENTROID_ATOL = 1e-3
# The share of depth and label pixels that may differ before the JAX
# centroids and gaussian are injected: a gaussian tie (C-w4) moves a flat
# region's depth by one unit, a centroid ulp (C-w10) an augmented frame's
# splat by a rounding.
RAW_SHARE = 0.05


def _check_case(tmp_path, intrin, cfg, frames, seed, mask=None):
    """Run both converters.  Where the centroids and the gaussians are
    equal, the datasets must be byte-equal.  Where they are not (C-w10,
    C-w4), the centroids must agree within CENTROID_ATOL, at most RAW_SHARE
    of the depth and label pixels may differ, and with the JAX centroids
    and gaussian injected the datasets must be byte-equal.  Returns the
    port's frame_count."""
    jc, tc, g_differ = _run_both(tmp_path / "raw", intrin, cfg, frames, seed,
                                 mask)
    np.testing.assert_allclose(tc, jc, rtol=0, atol=CENTROID_ATOL)
    frames_written = len([f for f in _tree_files(tmp_path / "raw" / "port")
                          if f.endswith("_depth.png")])
    if (tc == jc).all() and not any(g_differ):
        _assert_same_dataset(tmp_path / "raw")
        return frames_written
    pixels = 2 * frames_written * intrin.width * intrin.height
    assert _pixel_mismatches(tmp_path / "raw") <= RAW_SHARE * pixels
    jc2, _, _ = _run_both(tmp_path / "injected", intrin, cfg, frames, seed,
                          mask, inject=jc)
    np.testing.assert_array_equal(jc2, jc)
    _assert_same_dataset(tmp_path / "injected")
    return frames_written


def _scenes(intrin, n):
    return [(*_colored_scene(intrin, t), None, None) for t in range(n)]


def test_color_mapping_matches_jax(rng):
    intrin = CameraIntrinsics.d415(106, 60)
    _, color = _colored_scene(intrin)
    cfg = datagen.DatagenConfig(num_colors=3, color_em_tries=4,
                                color_em_iterations=16)
    want = jdatagen.make_color_mapping(color, cfg, np.random.default_rng(5))
    got = datagen.make_color_mapping(color, cfg, np.random.default_rng(5),
                                     device="cpu")
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


def test_end_to_end_matches_jax(tmp_path):
    intrin = CameraIntrinsics.d415(106, 60)
    cfg = datagen.DatagenConfig(
        num_colors=3, color_em_tries=3, color_em_iterations=12,
        plane_candidates=512, plane_z_threshold=40.0, max_images=5,
        scale_variance=0.05,
    )
    assert _check_case(tmp_path, intrin, cfg, _scenes(intrin, 6), 1234) == 5


def test_timestamp_gate_matches_jax(tmp_path):
    intrin = CameraIntrinsics.d415(106, 60)
    cfg = datagen.DatagenConfig(
        num_colors=3, color_em_tries=2, color_em_iterations=8,
        plane_candidates=512, frames_timestamp_max_diff=6.0,
    )
    depth, color = _colored_scene(intrin)
    frames = [(depth, color, 0.0, 0.004), (depth, color, 0.1, 0.110),
              (depth, color, None, None)]
    assert _check_case(tmp_path, intrin, cfg, frames, 7) == 2


def test_gaussian_path_matches_jax(tmp_path, rng):
    intrin = CameraIntrinsics.d415(106, 60)
    depth, color = _colored_scene(intrin)
    depth = depth + rng.integers(0, 12, depth.shape).astype(np.uint16)
    cfg = datagen.DatagenConfig(
        num_colors=3, color_em_tries=2, color_em_iterations=8,
        plane_candidates=512, gaussian_noise=3.0, max_images=4,
        scale_variance=0.05,
    )
    assert _check_case(tmp_path, intrin, cfg,
                       [(depth, color, None, None)] * 4, 0) == 4


def test_mask_model_slice_matches_jax(tmp_path):
    """212x120, the flagship's coarse layer as the mask (label 1 kept),
    the recipe's gaussian, augmented frames from frame 3 on."""
    intrin = CameraIntrinsics.d415(212, 120)
    cfg = datagen.DatagenConfig(
        num_colors=3, color_em_tries=3, color_em_iterations=12,
        plane_candidates=512, plane_z_threshold=40.0, scale_variance=0.04,
        gaussian_noise=1.5, max_images=6, mask_label=1,
    )
    frames = [(d, c, 0.01 * t, 0.01 * t + 0.002)
              for t, (d, c, _, _) in enumerate(_scenes(intrin, 6))]
    assert _check_case(tmp_path, intrin, cfg, frames, 3, mask=MASK_MODEL) == 6


def test_live_data_convert_app_on_cpu(tmp_path):
    """apps/live_data_convert_torch.py on a recorded session with colour,
    on the CPU (the mask model through B1's plain version: no launch);
    the dataset it writes loads through the port's reader."""
    import importlib.util

    from beats3d_tpu_torch.data.dataset import DatasetConfig
    from beats3d_tpu_torch.ops import forest_eval_cuda
    from beats3d_tpu_torch.runtime import camera
    from beats3d_tpu_torch.utils.intrinsics import CameraIntrinsics as TIntrin

    intrin = TIntrin.d415(106, 60)
    frames = [camera.Frame(depth=d, timestamp=0.01 * t, color=c,
                           color_timestamp=0.01 * t + (0.02 if t == 2 else 0))
              for t, (d, c, _, _) in enumerate(_scenes(intrin, 5))]
    camera.record_session(str(tmp_path / "s.npz"), frames, intrin)
    spec = importlib.util.spec_from_file_location(
        "live_data_convert_torch",
        os.path.join(ROOT, "apps", "live_data_convert_torch.py"))
    app = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(app)
    before = forest_eval_cuda.evaluate_forest_cuda.launches
    conv = app.run(["--session", str(tmp_path / "s.npz"), "-o",
                     str(tmp_path / "ds"), "--colors", "3",
                     "--plane_z_threshold", "40", "--mask_model", MASK_MODEL,
                     "--mask_label", "1", "--seed", "3", "--device", "cpu"])
    assert forest_eval_cuda.evaluate_forest_cuda.launches == before
    assert (conv.frame_count, conv.frames_skipped) == (4, 1)
    ds = DatasetConfig(str(tmp_path / "ds"), num_images=4,
                       image_idxes=list(range(4)))
    assert ds.get_depth_block(0).shape == (4, 60, 106)
    assert set(np.unique(ds.get_labels_block(0))) <= {0, 1, 2, 3}
