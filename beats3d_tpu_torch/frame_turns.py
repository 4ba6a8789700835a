"""The frame programs, or the trainer, of two checkouts in turns on one card.

    python -m beats3d_tpu_torch.frame_turns --parent DIR [--phase PHASE]
        [--out FILE]

``DIR`` is an earlier checkout of the repository (``git archive REV | tar
-x -C build/parent``; ``build/`` is not committed).  Four runs, each a child
process with its checkout as the working directory, so that each builds
and imports its own package: the parent, this checkout, this checkout, the
parent.

With ``--phase main_path`` (the default) a run makes ``chip_smoke.py``'s
main_path phase (the live tick pipelined and not, and the batched call,
timed and then profiled) and then times the frame calls of a fresh
FramePipeline between two CUDA events over many calls (``event_ms``; the
host's enqueue time beside it) and the live frame's graph replayed alone
(``graph_ms``): a bench scene (the crop branch), the oversized frame (the
full-frame branch), a clean batch of 16 and one with 3 oversized frames
(every frame full-frame).  With ``--phase train_path`` a run makes
``chip_smoke.py``'s train_path phase: train_forest at the flagship fine
layer's width (16 frames at 848x480, D=16, 3 candidate trees), its wall
seconds per candidate tree, and its second candidate tree profiled.

Prints one JSON line per run and writes them all to ``FILE`` (default
``build/frame_turns.json``, ``build/train_turns.json`` for train_path).
Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHILD = r'''
import json, sys, time
import torch
sys.path.insert(0, ".")
import chip_smoke as cs
from beats3d_tpu_torch import kernel_bench as kb
from beats3d_tpu_torch.runtime import pipeline as pl

smi = cs.phase_device()
inp = kb.bench_inputs(torch.device("cuda", 0))
cs.phase_main_path(inp, smi)
pipe = pl.FramePipeline(inp.model, inp.intrin)
big = pipe.as_depth(kb.oversized(inp.scenes[1], inp.intrin))
bad = inp.frames.clone()
for i in (1, 4, 9):
    bad[i] = pipe.as_depth(kb.oversized(inp.scenes[i], inp.intrin))


def per_call(fn, n):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    e0.record()
    for _ in range(n):
        fn()
    e1.record()
    host_ms = (time.perf_counter() - t0) * 1e3 / n
    torch.cuda.synchronize()
    return dict(event_ms=e0.elapsed_time(e1) / n, host_ms=host_ms, n=n)


res = {}
for name, frame in (("crop", inp.frames[0]), ("full", big)):
    res["live_" + name] = per_call(lambda: pipe(frame, inp.plane), 200)
    graph = pipe.graphs[("frame_step", tuple(frame.shape))].graph
    res["live_" + name]["graph_ms"] = per_call(graph.replay, 200)["event_ms"]
res["batched_clean"] = per_call(lambda: pipe.batch(inp.frames, inp.plane), 40)
res["batched_nbad3"] = per_call(lambda: pipe.batch(bad, inp.plane), 40)
print(json.dumps({"phase": "frame_ms", "card": smi, **res}), flush=True)
'''


TRAIN_CHILD = r'''
import sys
import torch
sys.path.insert(0, ".")
import chip_smoke as cs
from beats3d_tpu_torch.utils import CameraIntrinsics

cs.phase_train(CameraIntrinsics.d415(), torch.device("cuda", 0),
               cs.phase_device())
'''


def _run(tree: str, child: str = CHILD) -> dict:
    """One run's phases by name.  A run whose own checks fail (a profiler
    window can lose a kernel record, which main_path refuses) is made once
    more; the first attempt's error is kept under ``"retried"``."""
    errors = []
    for _ in range(2):
        proc = subprocess.run([sys.executable, "-c", child], cwd=tree,
                              capture_output=True, text=True, timeout=1500)
        if proc.returncode == 0:
            break
        errors.append(proc.stderr[-2000:])
    else:
        raise RuntimeError(f"the runs in {tree} failed:\n{errors[-1]}")
    phases = {"retried": errors} if errors else {}
    for line in proc.stdout.splitlines():
        if line.startswith('{"phase"'):
            rec = json.loads(line)
            phases[rec.pop("phase")] = rec
    return phases


def _summary(tree: str, phases: dict) -> dict:
    """The run's end-to-end and per-layer numbers, from its phases."""
    main = phases["main_path"]
    prof = main["profiled"]
    return dict(
        tree=tree, card=main["card"], retried=len(phases.get("retried", [])),
        live_pipelined_median_ms=main["ms_per_tick"]["pipelined"]["median"],
        live_unpipelined_median_ms=main["ms_per_tick"]["unpipelined"][
            "median"],
        batched_median_ms=main["ms_per_batched_call"]["median"],
        profiled={name: {k: w[k] for k in (
            "device_ops_per_call", "device_ms_per_call", "wall_ms_per_call",
            "idle_share", "host_syncs_per_call", "copies_DtoH_per_call",
            "graph_replays_per_call")} | {"k1_per_call": w["k1"][
                "launches_per_call"]} for name, w in prof.items()},
        frame_ms={k: v for k, v in phases["frame_ms"].items() if k != "card"})


def _train_summary(tree: str, phases: dict) -> dict:
    """The trainer's wall and per-candidate-tree seconds and its profiled
    candidate tree, from train_path."""
    train = phases["train_path"]
    window = train["profiled_candidate_tree"]["window"]
    return dict(
        tree=tree, card=train["card"],
        retried=len(phases.get("retried", [])), seconds=train["seconds"],
        seconds_per_candidate_tree=train["seconds_per_candidate_tree"],
        pct_match=train["pct_match"], b4_launches=train["b4_launches"],
        b1_launches=train["b1_launches"],
        profiled_candidate_tree={k: window[k] for k in (
            "device_ops_per_call", "device_ms_per_call", "wall_ms_per_call",
            "idle_share")})


PHASES = {"main_path": (CHILD, _summary, "frame_turns.json"),
          "train_path": (TRAIN_CHILD, _train_summary, "train_turns.json")}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True,
                    help="an earlier checkout of the repository")
    ap.add_argument("--phase", choices=sorted(PHASES), default="main_path")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    child, summary, out = PHASES[args.phase]
    out = args.out or os.path.join(ROOT, "build", out)
    parent = os.path.abspath(args.parent)
    runs = []
    for name, tree in (("parent", parent), ("this", ROOT), ("this", ROOT),
                       ("parent", parent)):
        phases = _run(tree, child)
        runs.append(dict(summary=summary(name, phases), phases=phases))
        print(json.dumps(runs[-1]["summary"]), flush=True)
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        json.dump(runs, f, indent=1)


if __name__ == "__main__":
    main()
