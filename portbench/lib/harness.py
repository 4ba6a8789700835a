"""What every cell's run shares: finding the cell, its configuration, its
traffic mix and its metrics by name; the run's environment; the check that
nothing of JAX or of the JAX package is loaded; the result line.

Everything is found by the names in ``BENCHMARK.json``:

* a cell's workload file is ``portbench/workloads/<cell>.json``: its
  ``driver`` (``portbench/drivers/<driver>.py``, which runs the system
  under test), its ``traffic`` parameters (read by ``portbench/traffic``)
  and the ``limits`` of the numbers that decide ``correct``;
* a configuration is the ``file`` its manifest entry names;
* a metric is ``portbench/metrics/<metric>.py``, whose ``read(rec)``
  takes the metric from the run's record and returns None when the run
  holds nothing to read.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BENCH = os.path.join(ROOT, "portbench")
# Build and kernel caches at fixed paths inside the checkout, so that only a
# checkout's first run builds: the program builds its CUDA kernels into its
# checkout's build/beats3d_tpu_torch/ by itself.
CACHE_DIRS = {"TRITON_CACHE_DIR": os.path.join("build", "portbench", "triton"),
              "TORCH_EXTENSIONS_DIR": os.path.join("build", "portbench",
                                                   "torch_extensions")}
# The traffic generator's frames that do not depend on the seed, made by a
# checkout's first run and loaded by the others.
FRAMES_DIR = os.path.join("build", "portbench", "frames")
# Top-level module names that no run may load, compared whole.
FORBIDDEN = ("jax", "jaxlib", "flax", "beats3d_tpu")


class Refused(Exception):
    """A run that must print no result (exit code 3)."""


def set_env(root: str = ROOT):
    """The run's environment, before torch is imported."""
    for k, rel in CACHE_DIRS.items():
        os.environ[k] = os.path.join(root, rel)
        os.makedirs(os.environ[k], exist_ok=True)
    # keep libraries from loading JAX by themselves
    os.environ["USE_FLAX"] = "0"


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def manifest(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def find(items, name: str, what: str):
    for it in items:
        if it["name"] == name:
            return it
    raise Refused(f"no {what} named {name!r} in BENCHMARK.json")


def applies(metric: dict, cell: str, man: dict) -> bool:
    """Whether ``metric`` is reported in ``cell``: its ``workloads`` list,
    else (a per-layer metric) every cell that reports the end-to-end
    metric it moves, else (an end-to-end metric) every cell."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    if "moves" in metric:
        e2e = find(man["end_to_end"], metric["moves"], "metric")
        return applies(e2e, cell, man)
    return True


def reader(name: str, bench: str = BENCH):
    """``read`` of ``portbench/metrics/<name>.py``."""
    path = os.path.join(bench, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def driver(name: str, bench: str = BENCH):
    """The module ``portbench/drivers/<name>.py``."""
    path = os.path.join(bench, "drivers", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "portbench.drivers." + name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_loaded(modules=None):
    """The forbidden top-level names among the loaded modules (the part of
    each name before the first dot, compared whole)."""
    modules = sys.modules if modules is None else modules
    tops = {m.split(".", 1)[0] for m in list(modules)}
    return sorted(t for t in tops if t in FORBIDDEN)


def sample(seed: int, salt: int, upto: int, k: int):
    """``k`` distinct indices in [0, upto) drawn from the seed."""
    rng = np.random.default_rng([seed, salt])
    return set(int(i) for i in rng.choice(upto, min(k, upto), replace=False))


@dataclasses.dataclass
class Ctx:
    """One run: its arguments, cell, configuration and traffic."""
    cell: str
    seed: int
    seconds: float
    trace: bool
    device: object          # torch.device
    tmpdir: str
    config: dict
    workload: dict
    t_start: float          # the process's start on the host clock
    root: str = ROOT

    @property
    def traffic(self) -> dict:
        return self.workload["traffic"]

    def path(self, rel: str) -> str:
        return os.path.join(self.root, rel)

    @property
    def frames_dir(self) -> str:
        return self.path(FRAMES_DIR)

    def sync(self):
        import torch
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def power_limit():
    """The card's ``name, power.limit`` as nvidia-smi reads it, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def run_cell(man: dict, cell: dict, *, seed: int, seconds: float,
             trace: bool, device, tmpdir: str, t_start: float,
             root: str = ROOT, bench: str = BENCH, config=None,
             workload=None):
    """Run one cell and return (result line, checks table).  ``config``
    and ``workload``, when given, stand in for the files (tests)."""
    if config is None:
        cfg_entry = find(man["configs"], cell["config"], "configuration")
        config = load_json(os.path.join(root, cfg_entry["file"]))
    if workload is None:
        workload = load_json(os.path.join(bench, "workloads",
                                          cell["name"] + ".json"))
    ctx = Ctx(cell["name"], seed, seconds, trace, device, tmpdir, config,
              workload, t_start, root)
    rec = driver(workload["driver"], bench).run(ctx)
    found = forbidden_loaded()
    if found:
        raise Refused(f"loaded in the run: {found}")
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in man[kind]:
        if not applies(m, cell["name"], man):
            continue
        value = reader(m["name"], bench)(rec)
        if value is None:
            if kind == "end_to_end":
                raise RuntimeError(f"end-to-end metric {m['name']} read "
                                   "nothing")
            continue
        metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    checks = rec["checks"]
    import torch
    cuda = device.type == "cuda"
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": int(rec["peak_bytes"])}
    if cuda:
        dev["power_limit"] = power_limit()
    out = {"correct": bool(checks.correct), "attempted": int(rec["attempted"]),
           "failed": int(checks.failed), "metrics": metrics, "device": dev}
    if trace:
        t = rec["trace"]
        dev["busy_s"] = t["busy_s"]
        dev["window_s"] = t["window_s"]
        out["breakdown"] = t["breakdown"]
    out["run"] = {"seed": seed, "seconds": seconds,
                  "process_s": time.perf_counter() - t_start,
                  "reference_s": rec.get("reference_s"),
                  "window_s": rec.get("window_s"),
                  "threads": torch.get_num_threads()}
    if rec.get("spans"):
        out["run"]["host_spans_ms"] = rec["spans"]
    if "tick_s" in rec:
        ms = np.asarray(rec["tick_s"]) * 1e3
        out["run"]["tick_ms"] = {
            f"p{q}": float(np.percentile(ms, q))
            for q in (50, 90, 95, 99, 99.9)}
        out["run"]["tick_ms"]["over_5ms"] = int((ms > 5).sum())
        out["run"]["tick_ms"]["over_11ms"] = int((ms > 11.1).sum())
        out["run"]["midi_events"] = rec.get("midi_events")
    out["compared"] = checks.table()
    return out, checks.table()


def emit(result: dict, table: dict):
    """The checks as the last lines of standard error, then the result as
    the last line of standard output."""
    for k, v in table.items():
        print(f"check {k}: {v['value']!r} (limit {v['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
