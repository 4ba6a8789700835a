"""The batched call: ``FramePipeline.batch`` on B frames with one plane,
called back to back (a closed loop, as an offline relabelling of recorded
sessions runs), each call followed by one host read of its heights, tip
flags and hand groups.

Set-up: the scenes, on the device as int32, and their B rotations (call c
takes rotation c mod B, so consecutive calls differ); the model and the
pipeline with the configuration's settings; the plane calibrated by the
program's ``CalibratedPlane`` from the first scene; two warm calls (the
first captures the batch's CUDA graph).  Window: calls until ``--seconds``
have passed.  The run keeps every call's host read, and the full outputs
of calls drawn from the seed and of the last B calls; with ``--trace 1``
also a traced window of ``trace_calls`` calls.  Then the program's state
is freed and the reference computes the batch once (a frame's outputs do
not depend on its place in the batch), its plane from the same uniforms.
"""

from __future__ import annotations

import collections
import time

import numpy as np
import torch

from ..lib import frames as fr
from ..lib import harness, trace
from ..reference import compare
from ..traffic import scenes as traffic

SAMPLED = 8
SAMPLE_RANGE = 2048


def run(ctx):
    from beats3d_tpu_torch.models import LayeredDecisionForest
    from beats3d_tpu_torch.ops import plane as plane_ops
    from beats3d_tpu_torch.ops import points
    from beats3d_tpu_torch.runtime.pipeline import (FramePipeline,
                                                    PipelineConfig)
    from beats3d_tpu_torch.utils import CameraIntrinsics

    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    pc, cam = cfg["pipeline"], cfg["camera"]
    scenes, big = traffic.frames(tr, ctx.seed, cam, cache=ctx.frames_dir)
    b = scenes.shape[0]
    frames = torch.as_tensor(scenes.astype(np.int32)).to(dev)
    order = [(np.arange(b) + r) % b for r in range(b)]
    rolls = [frames[torch.as_tensor(o, device=dev)].contiguous()
             for o in order]
    intrin = CameraIntrinsics(**cam)
    model = LayeredDecisionForest.load(
        ctx.path(cfg["model"]), labels_reduce=pc["labels_reduce"], device=dev)
    pcfg = PipelineConfig(**fr.pipeline_kwargs(
        cfg, PipelineConfig.__dataclass_fields__))
    fr.check_pipeline(cfg, pcfg)
    pipe = FramePipeline(model, intrin, cfg=pcfg,
                         plane_z_threshold=pc["plane_z_threshold"],
                         group_min_size=pc["group_min_size"])
    p = cfg["plane"]
    plane = plane_ops.CalibratedPlane(
        p["num_candidates"], p["threshold"], seed=p["seed"], device=dev).make(
        points.deproject_points(frames[0], intrin.pp, intrin.fx))
    state = {"c": 0}

    def call():
        """One batched call and its host read; returns (outputs, host read,
        rotation)."""
        c = state["c"]
        state["c"] = c + 1
        r = c % b
        out = pipe.batch(rolls[r], plane)
        host = torch.cat([out["heights"].reshape(-1),
                          out["tip_valid"].reshape(-1).to(torch.float32),
                          out["g_info"].reshape(-1)]).cpu()
        return out, host, r

    for _ in range(2):
        call()
    ctx.sync()
    setup_s = time.perf_counter() - ctx.t_start

    picks = harness.sample(ctx.seed, 2, SAMPLE_RANGE, SAMPLED)
    kept, last, hosts = [], collections.deque(maxlen=b), []
    t0 = time.perf_counter()
    end = t0 + ctx.seconds
    i = 0
    while True:
        out, host, r = call()
        hosts.append((host, r))
        if i in picks:
            kept.append((out, r))
        last.append((out, r))
        i += 1
        if time.perf_counter() >= end:
            break
    ctx.sync()
    window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    rec = dict(setup_s=setup_s, window_s=window_s, attempted=i, batch=b,
               calls_per_s=i / window_s, peak_bytes=peak, trace=None,
               oversized=len(big))
    if ctx.trace:
        rec["trace"] = trace.traced(call, int(tr["trace_calls"]), ctx.tmpdir,
                                    sync=ctx.sync)
    compared = [(fr.to_host(o), r) for o, r in list(kept) + list(last)]
    hosts = [(h.numpy(), r) for h, r in hosts]
    mat = plane.cpu().numpy()
    del pipe, model, frames, rolls, out, kept, last
    fr.free_program()

    t_ref = time.perf_counter()
    ref, work, ref_mat = fr.reference(ctx, scenes, 0, batch=True)
    checks = compare.Checks(ctx.workload["limits"])
    checks.answer(plane_off=compare.max_abs_off(mat, ref_mat))
    nt = 2 * len(pc["fingertip_label_ids"])
    for o, r in compared:
        for j, s in enumerate(order[r]):
            checks.answer(**compare.frame_readings(
                {k: v[j] for k, v in o.items()}, ref[int(s)]))
    hs = np.stack([h for h, _ in hosts])
    rs = np.array([r for _, r in hosts])
    ref_h = np.stack([np.stack([ref[int(s)]["heights"] for s in o])
                      for o in order])
    ref_v = np.stack([np.stack([ref[int(s)]["tip_valid"] for s in o])
                      for o in order])
    checks.answers_many(**compare.host_block_readings(
        hs[:, :b * nt].reshape(-1, b, 2, nt // 2),
        hs[:, b * nt:2 * b * nt].reshape(-1, b, 2, nt // 2) != 0,
        ref_h[rs], ref_v[rs]))
    rec.update(checks=checks, reference_s=time.perf_counter() - t_ref,
               k1_bound_s=fr.k1_work(cfg, work)[2],
               ops_per_call=fr.frame_ops(cfg, work, b))
    return rec
