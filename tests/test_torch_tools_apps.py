"""The port's remaining apps and host tools against the JAX package's, on
the CPU at 212x120 or smaller: run_live_layered_torch's frame function
(labels bit for bit, RGBA equal), pointcloids_torch's plane line, the
stereo_depth_torch and make_proj_image_torch CLIs' PNG pixels, and the
structured log records."""

import importlib
import io
import json
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import fixtures

from beats3d_tpu.models import LayeredDecisionForest as JaxLayered
from beats3d_tpu.ops import plane as jplane
from beats3d_tpu.ops import points as jpoints
from beats3d_tpu.runtime.camera import SyntheticSource
from beats3d_tpu.utils import CameraIntrinsics
from beats3d_tpu.utils import logging as jlogging
from beats3d_tpu_torch.data.synth import PROJECTOR_TILE_CORNERS, projector_photo
from beats3d_tpu_torch.models import LayeredDecisionForest
from beats3d_tpu_torch.utils import logging as tlogging



def _app(name):
    return importlib.import_module(f"apps.{name}")


def _run_main(monkeypatch, mod, argv):
    """An app's main() as its command line would run it."""
    monkeypatch.setattr(sys, "argv", [mod.__file__] + argv)
    return mod.main()


def test_run_live_layered_frame_matches_jax(tmp_path, rng):
    intrin = CameraIntrinsics.d415(212, 120)
    cfg_path = fixtures.layered_cfg_fixture(str(tmp_path), rng)
    jm = JaxLayered.load(cfg_path, labels_reduce=2)
    tm = LayeredDecisionForest.load(cfg_path, labels_reduce=2, device="cpu")
    src = SyntheticSource(intrin)
    frames = [src.make_frame(t) for t in (0, 7)]
    pts = jpoints.deproject_points(jnp.asarray(frames[0]),
                                   jnp.asarray(intrin.pp),
                                   jnp.float32(intrin.fx))
    mat = np.array(jplane.CalibratedPlane(512, 40.0).make(pts))
    jax_app = _app("run_live_layered")
    port_app = _app("run_live_layered_torch")
    scale = intrin.width / port_app.TRAIN_DIM_X
    for depth in frames:
        want_labels, want_rgba = jax_app._frame(
            jnp.asarray(depth), jnp.asarray(mat), jnp.asarray(intrin.pp),
            jnp.float32(intrin.fx), jm.layer_tables(), jm.conditions,
            jnp.asarray(jm.label_colors), jnp.float32(40.0),
            jnp.float32(scale),
            filter_specs=tuple((l.filter_model, l.filter_model_class)
                               for l in jm.layers),
            labels_reduce=2)
        labels, rgba = port_app.frame_labels(
            torch.as_tensor(depth.astype(np.int32)), torch.as_tensor(mat),
            intrin.pp, intrin.fx, tm, 40.0, scale)
        want_labels = np.asarray(want_labels)
        assert labels.shape == want_labels.shape == (60, 106)
        np.testing.assert_array_equal(labels.numpy(), want_labels)
        np.testing.assert_array_equal(rgba.numpy(), np.asarray(want_rgba))
        assert (want_labels != 65535).any()


def test_run_live_layered_cli_cpu(tmp_path, rng, capsys):
    cfg_path = fixtures.layered_cfg_fixture(str(tmp_path), rng)
    n = _app("run_live_layered_torch").run([
        "-cfg", cfg_path, "--device", "cpu", "--synthetic",
        "--rs_half_resolution", "--plane_num_iterations", "256",
        "--frames", "31"])
    assert n == 31
    assert "frame 30:" in capsys.readouterr().out


def test_pointcloids_plane_line_matches_jax(tmp_path, monkeypatch, capsys):
    lines = []
    for name in ("pointcloids", "pointcloids_torch"):
        out = tmp_path / f"{name}.html"
        _run_main(monkeypatch, _app(name), [
            "--synthetic", "--rs_half_resolution", "--stride", "4",
            "--ransac_iters", "200", "-o", str(out)])
        stdout = capsys.readouterr().out
        lines.append([l for l in stdout.splitlines() if "plane normal" in l])
        html = out.read_text()
        assert "pointcloids" in html and "orbit" in html
    assert len(lines[0]) == 1 and "inliers" in lines[0][0]
    assert lines[1] == lines[0]


def _png(path, arr):
    Image.fromarray(arr).save(path)
    return str(path)


def test_stereo_depth_cli_matches_jax(tmp_path, monkeypatch, capsys):
    rng = np.random.default_rng(21)
    h, w, d_true = 48, 160, 5
    texture = rng.integers(0, 255, (h, w + d_true)).astype(np.uint8)
    left = _png(tmp_path / "l.png", texture[:, :w])
    right = _png(tmp_path / "r.png", np.ascontiguousarray(
        np.stack([texture[:, d_true:]] * 3, axis=-1)))   # RGB: channel 0
    outs = {}
    for name, extra in (("stereo_depth", []),
                        ("stereo_depth_torch", ["--device", "cpu"])):
        out = tmp_path / f"{name}.png"
        _run_main(monkeypatch, _app(name), [
            "--left", left, "--right", right, "--out", str(out),
            "--max_disparity", "16", "--block_size", "7"] + extra)
        outs[name] = np.asarray(Image.open(out))
        assert "valid px" in capsys.readouterr().out
    assert outs["stereo_depth_torch"].dtype == np.uint16
    np.testing.assert_array_equal(outs["stereo_depth_torch"],
                                  outs["stereo_depth"])
    assert (outs["stereo_depth"] == 20000).mean() > 0.5


def test_make_proj_image_cli_matches_jax(tmp_path, monkeypatch, capsys):
    src = _png(tmp_path / "photo.png", projector_photo())
    corners = [f"{int(x)},{int(y)}" for x, y in PROJECTOR_TILE_CORNERS]
    outs = {}
    for name, extra in (("make_proj_image", []),
                        ("make_proj_image_torch", ["--device", "cpu"])):
        out = tmp_path / f"{name}.png"
        _run_main(monkeypatch, _app(name), [
            "--src", src, "--corners", *corners, "--out", str(out),
            "--tile_size", "40", "--num_tiles", "3"] + extra)
        outs[name] = np.asarray(Image.open(out))
        assert "120x120" in capsys.readouterr().out
    np.testing.assert_array_equal(outs["make_proj_image_torch"],
                                  outs["make_proj_image"])


@pytest.mark.parametrize("json_lines", [True, False])
def test_log_records_match_jax(json_lines):
    records = {}
    for tag, mod in (("jax", jlogging), ("port", tlogging)):
        stream = io.StringIO()
        name = f"beats3d.test.{tag}.{json_lines}"
        log = mod.get_logger(name, json_lines=json_lines, stream=stream)
        assert mod.get_logger(name) is log     # configured once
        log.info("fps=%.1f", 90.0)
        log.warning("late frame", extra={"metrics": {"latency_ms": 6.0}})
        records[tag] = stream.getvalue().splitlines()
    assert len(records["jax"]) == len(records["port"]) == 2
    if json_lines:
        for a, b in zip(records["jax"], records["port"]):
            ja, jb = json.loads(a), json.loads(b)
            assert ja.keys() == jb.keys()
            assert {k: v for k, v in ja.items() if k != "ts"} == {
                k: v for k, v in jb.items() if k != "ts"} | {
                "logger": ja["logger"]}
        first, second = (json.loads(r) for r in records["port"])
        assert first["level"] == "INFO" and first["msg"] == "fps=90.0"
        assert second["level"] == "WARNING" and second["metrics"] == {
            "latency_ms": 6.0}
    else:
        assert "INFO fps=90.0" in records["port"][0]
        assert "WARNING late frame" in records["port"][1]
