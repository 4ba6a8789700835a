"""beats3d_tpu_torch stands apart from JAX: importing the port (and its
application) loads no JAX module and no module of the JAX package; the
port's sources import neither; the model parameters carried across with
``from_numpy`` equal the port's own loading of the flagship artifacts; and
chip_smoke.py refuses to run (and prints no result) without a card or
outside a checkout."""

import gzip
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from beats3d_tpu.models import LayeredDecisionForest as JaxLayered
from beats3d_tpu_torch.models import LayeredDecisionForest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "beats3d_tpu_torch")
FLAGSHIP = os.path.join(ROOT, "models", "flagship")


def _clean_env():
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT
    return env


def test_import_loads_no_jax():
    code = (
        "import sys\n"
        "import beats3d_tpu_torch, beats3d_tpu_torch.runtime.app, "
        "beats3d_tpu_torch.runtime.camera, beats3d_tpu_torch.data.synth, "
        "beats3d_tpu_torch.train, beats3d_tpu_torch.data.dataset, "
        "beats3d_tpu_torch.data.blocks, beats3d_tpu_torch.data.device_codec, "
        "beats3d_tpu_torch.probes, beats3d_tpu_torch.probes.__main__\n"
        "import apps.train_model_torch, apps.test_on_saved_model_torch, "
        "apps.run_live_torch\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m.startswith('jaxlib') or m == 'beats3d_tpu' "
        "or m.startswith('beats3d_tpu.')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          env=_clean_env(), capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_sources_import_no_jax():
    pattern = re.compile(
        r"^\s*(import jax|from jax|import beats3d_tpu\b|from beats3d_tpu\b"
        r"(?!_torch))", re.M)
    files = [os.path.join(d, f) for d, _, fs in os.walk(PKG) for f in fs
             if f.endswith(".py")]
    files += [os.path.join(ROOT, "chip_smoke.py")]
    files += [os.path.join(ROOT, "apps", f"{name}_torch.py") for name in (
        "bz3d", "train_model", "test_on_saved_model", "run_live")]
    assert len(files) > 15
    for path in files:
        with open(path) as f:
            assert not pattern.search(f.read()), path


def test_from_numpy_round_trips_flagship(tmp_path):
    for name in ("m0.npy", "model_cfg.json"):
        shutil.copy(os.path.join(FLAGSHIP, name), tmp_path / name)
    with gzip.open(os.path.join(FLAGSHIP, "m1.npy.gz"), "rb") as f:
        (tmp_path / "m1.npy").write_bytes(f.read())
    jm = JaxLayered.load(str(tmp_path / "model_cfg.json"), labels_reduce=2)
    carried = LayeredDecisionForest.from_numpy(
        [(l.flat, l.filter_model, l.filter_model_class) for l in jm.layers],
        jm.conditions_np, jm.label_colors, "cpu", labels_reduce=2)
    loaded = LayeredDecisionForest.load(
        os.path.join(FLAGSHIP, "model_cfg.json"), labels_reduce=2,
        device="cpu")
    assert carried.num_layered_classes == loaded.num_layered_classes == 6
    assert carried.filter_specs() == loaded.filter_specs() == ((None, None),
                                                               (0, 1))
    np.testing.assert_array_equal(carried.conditions.numpy(),
                                  np.asarray(jm.conditions))
    np.testing.assert_array_equal(carried.label_colors, loaded.label_colors)
    for lc, ll, lj in zip(carried.layers, loaded.layers, jm.layers):
        assert torch.equal(lc.flat, ll.flat)
        np.testing.assert_array_equal(lc.flat.numpy(), lj.flat)
        assert lc.forest.max_depth == lj.forest.max_depth
    assert tuple(carried.layers[1].flat.shape) == (4, 65535, 21)


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_refuses_without_card_or_checkout(tmp_path, alone):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    script = os.path.join(ROOT, "chip_smoke.py")
    cwd = ROOT
    env = _clean_env()
    if alone:
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script, cwd = str(tmp_path / "chip_smoke.py"), str(tmp_path)
        env.pop("PYTHONPATH")
    proc = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
