"""Nothing a run loads is JAX or the JAX package, compared by whole
top-level names (the port's name begins with the JAX package's), and the
reference loads nothing of the program either."""

import os
import subprocess
import sys

from portbench.lib import harness


def test_names_compared_whole():
    mods = {"beats3d_tpu_torch": 1, "beats3d_tpu_torch.ops": 1,
            "jaxtyping": 1, "numpy": 1}
    assert harness.forbidden_loaded(mods) == []
    mods.update({"beats3d_tpu.ops.plane": 1, "jaxlib.xla": 1})
    assert harness.forbidden_loaded(mods) == ["beats3d_tpu", "jaxlib"]
    assert harness.forbidden_loaded({"flax": 1, "jax": 1}) == ["flax", "jax"]


def _loaded_by(code):
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\n"
         "print(sorted({m.split('.')[0] for m in sys.modules}))"],
        cwd=harness.ROOT, capture_output=True, text=True, check=True,
        env=dict(os.environ, PYTHONPATH=harness.ROOT))
    return eval(out.stdout.strip().splitlines()[-1])


def test_reference_loads_nothing_of_the_program():
    tops = _loaded_by(
        "import portbench.reference.forest, portbench.reference.frame, "
        "portbench.reference.plane, portbench.reference.taps, "
        "portbench.reference.trainer, portbench.reference.compare, "
        "portbench.control, portbench.work.counts, "
        "portbench.traffic.scenes")
    for name in ("beats3d_tpu", "beats3d_tpu_torch", "jax", "jaxlib",
                 "flax"):
        assert name not in tops


def test_a_run_loads_no_jax():
    # a whole small run of the live cell in a process of its own, the
    # program and the reference with it
    tops = _loaded_by(
        "from portbench.tests.conftest import run_small\n"
        "res, _ = run_small('flagship.live')\n"
        "assert res['correct'], res")
    assert "beats3d_tpu_torch" in tops
    for name in harness.FORBIDDEN:
        assert name not in tops


def test_run_py_refuses_without_a_card_or_the_port(tmp_path):
    # the card machine's check: with only BENCHMARK.json and portbench/ in
    # the directory (no port), or here with no card, a run prints no result
    import shutil
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(harness.BENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "flagship.live",
         "--seed", "3", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert out.returncode != 0 and out.stdout.strip() == ""
