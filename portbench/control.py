#!/usr/bin/env python3
"""The control of each cell's comparison: the plain reference put in the
program's place, computed in the precision below the configuration's
(bfloat16 for its float32 plane, K2's plane test and gaussian, the forest
feature and mean shift, the trainer's feature and scoring; the frame path has no matrix product, so
TF32 would change nothing), and judged by the same comparison as a run.  It has to
come out not correct.

    python3 portbench/control.py --workload CELL --seeds 1 2 3

prints, per seed, each number the comparison reads beside its limit and
whether the control passed, as one JSON line.  On the cell's own sizes it
runs on the card (``--device cuda``); the tests run it on the CPU at a
small size.  The benchmark's runs never run it.  Imports nothing of the
program.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from portbench.lib import harness  # noqa: E402
from portbench.reference import (  # noqa: E402
    compare, frame, models, plane, taps, trainer as ref_trainer)
from portbench.traffic import scenes as traffic  # noqa: E402

LOW = torch.bfloat16
CYCLES = 4          # the live cell's MIDI replay: cycles of its scenes


def _frame_outputs(cfg, scenes, dev, ftype, batch):
    """(plane, {scene: outputs}) of the reference at ``ftype``: the plane
    from the calibrated plane's uniforms, rounded to ``ftype``, and the
    frame program on it."""
    cam = cfg["camera"]
    model, run_layered = models.load(cfg, ROOT, dev)
    raw = torch.as_tensor(scenes.astype(np.int32)).to(dev)
    calib = cfg["app"]["warmup_frames"] % len(scenes) if not batch else 0
    pts = frame.deproject_points(
        raw[calib], np.array([cam["ppx"], cam["ppy"]], np.float32), cam["fx"])
    p = cfg["plane"]
    mat = plane.calibrate_plane(plane.draw_uniforms(
        p["num_candidates"], p["seed"], dev), pts, float(p["threshold"]))
    mat = mat.to(ftype).to(torch.float32)
    ref = frame.RefPipeline(model, cam, cfg["pipeline"], dev, ftype=ftype,
                            run_layered=run_layered)
    keys = ("labels", "means", "heights", "tip_valid", "g_info",
            "guard_muted")
    if batch:
        o = ref.batch(raw, mat)
        outs = {i: {k: o[k][i].cpu().numpy() for k in keys}
                for i in range(raw.shape[0])}
    else:
        outs = {i: {k: v.cpu().numpy() for k, v in ref.frame(
            raw[i], mat).items() if k in keys} for i in range(raw.shape[0])}
    return mat.cpu().numpy(), outs


def frame_control(cfg, workload, seed, dev):
    """The control's numbers of one seed of a frame cell."""
    scenes, _ = traffic.frames(workload["traffic"], seed, cfg["camera"])
    batch = workload["driver"] == "batch"
    want_mat, want = _frame_outputs(cfg, scenes, dev, torch.float32, batch)
    got_mat, got = _frame_outputs(cfg, scenes, dev, LOW, batch)
    checks = compare.Checks(workload["limits"])
    checks.answer(plane_off=compare.max_abs_off(got_mat, want_mat))
    for i in want:
        checks.answer(**compare.frame_readings(got[i], want[i]))
    if "midi_off" in workload["limits"]:
        seq = list(range(len(scenes))) * CYCLES
        ev = lambda o: taps.replay([o[s]["heights"] for s in seq],
                                   [o[s]["tip_valid"] for s in seq],
                                   cfg["app"])
        checks.answer(midi_off=compare.events_off(ev(got), ev(want)))
    return checks


def train_control(cfg, workload, seed, dev):
    """The control's numbers of one seed of a training cell: one candidate
    tree trained and scored at the low precision from the window's first
    generator state, against the reference."""
    t = cfg["training"]
    (d_tr, l_tr), (d_te, l_te) = traffic.labelled_frames(
        workload["traffic"], seed, cfg["camera"])
    kw = dict(depth_limit=t["depth"], proposals=t["proposals"],
              proposals_per_block=t["proposals_per_block"],
              images_per_block=t["images_per_block"], device=dev)
    state = np.random.default_rng([seed, 2]).bit_generator.state
    trees = {}
    for ftype in (torch.float32, LOW):
        rng = np.random.default_rng()
        rng.bit_generator.state = state
        trees[ftype] = ref_trainer.train_tree(d_tr, l_tr, t["classes"],
                                              rng=rng, ftype=ftype, **kw)
    low = trees[LOW]
    acc_low = ref_trainer.tree_accuracy(low, d_te, l_te, dev, ftype=LOW)
    checks = compare.Checks(workload["limits"])
    checks.answer(score_off=abs(
        acc_low - ref_trainer.tree_accuracy(low, d_te, l_te, dev)))
    checks.answer(tree_rows_off=int(np.sum(np.any(
        low != trees[torch.float32], axis=1))))
    return checks


def control(cfg, workload, seed, dev):
    if workload["driver"] == "train":
        return train_control(cfg, workload, seed, dev)
    return frame_control(cfg, workload, seed, dev)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    man = harness.manifest()
    cell = harness.find(man["workloads"], args.workload, "cell")
    cfg = harness.load_json(os.path.join(ROOT, harness.find(
        man["configs"], cell["config"], "configuration")["file"]))
    workload = harness.load_json(os.path.join(
        harness.BENCH, "workloads", cell["name"] + ".json"))
    dev = torch.device(args.device)
    for seed in args.seeds:
        t0 = time.perf_counter()
        checks = control(cfg, workload, seed, dev)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control_correct": checks.correct,
                          "seconds": time.perf_counter() - t0,
                          "compared": checks.table()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
