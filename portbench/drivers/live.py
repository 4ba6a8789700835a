"""The live instrument: ``BeatsApp.tick`` fed back to back (a closed loop
of one stream, as a replayed session is), with the configuration's
``AppConfig`` (pipelined), MIDI to the program's event sink.

Set-up: the scenes, the model, the app; the warm-up frames, the tick that
calibrates the plane (RANSAC) and captures the frame's CUDA graph, and a
few warm ticks.  Window: ticks until ``--seconds`` have passed, each tick's
end on the host clock (the last one after a synchronise).  The run keeps
every tick's host copy (heights, tip_valid, guard_muted), the full outputs
of ticks drawn from the seed and of the last ticks, and the MIDI messages
sent, and the app's host spans (its timer's, read after the window); with
``--trace 1`` also a traced window of ``trace_ticks`` ticks.
Then the program's state is freed and the reference computes every scene
(its plane from the same uniforms) and the MIDI messages of the whole
sequence of frames that the app's tap state consumed.
"""

from __future__ import annotations

import collections
import time

import numpy as np
import torch

from ..lib import frames as fr
from ..lib import harness, trace
from ..reference import compare, taps
from ..traffic import scenes as traffic

WARM_TICKS = 8         # after the capture: the pinned fetch buffer and more
SAMPLED = 24           # window ticks drawn from the seed, among the first
SAMPLE_RANGE = 4096


class _Source:
    """The app's frame source: only its intrinsics are read."""

    def __init__(self, intrin):
        self.intrinsics = intrin

    def stop(self):
        pass


def run(ctx):
    from beats3d_tpu_torch.models import LayeredDecisionForest
    from beats3d_tpu_torch.runtime.app import AppConfig, BeatsApp
    from beats3d_tpu_torch.runtime.camera import Frame
    from beats3d_tpu_torch.runtime.midi import Midi
    from beats3d_tpu_torch.utils import CameraIntrinsics

    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    scenes, _ = traffic.frames(tr, ctx.seed, cfg["camera"],
                               cache=ctx.frames_dir)
    n = scenes.shape[0]
    model = LayeredDecisionForest.load(
        ctx.path(cfg["model"]), labels_reduce=cfg["pipeline"]["labels_reduce"],
        device=dev)
    midi = Midi()
    midi.out = None                      # the event sink only
    app_cfg = {k: (tuple(v) if isinstance(v, list) else v)
               for k, v in cfg["app"].items()}
    app = BeatsApp(model, _Source(CameraIntrinsics(**cfg["camera"])),
                   midi=midi, cfg=AppConfig(**app_cfg), log=lambda *a: None)
    fr.check_pipeline(cfg, app.pipeline.cfg)
    cp = app.calibrated_plane
    if (cp.num_random_guesses, cp.plane_z_outlier_threshold) != (
            cfg["plane"]["num_candidates"], cfg["plane"]["threshold"]):
        raise RuntimeError("the app's plane calibration is not the one the "
                           "configuration file states")
    feed = [Frame(depth=s, timestamp=0.0) for s in scenes]
    state = {"k": 0}

    def tick():
        """One tick on the next scene; returns (output, its scene)."""
        k = state["k"]
        state["k"] = k + 1
        return app.tick(feed[k % n]), (k - 1) % n

    first = app.cfg.warmup_frames          # the tick that calibrates
    for _ in range(first + 1 + WARM_TICKS):
        tick()
    ctx.sync()
    setup_s = time.perf_counter() - ctx.t_start

    picks = harness.sample(ctx.seed, 1, SAMPLE_RANGE, SAMPLED)
    kept, last, hosts = [], collections.deque(maxlen=n), []
    app.timer.reset()
    ts = [time.perf_counter()]
    end = ts[0] + ctx.seconds
    i = 0
    while True:
        out, s = tick()
        now = time.perf_counter()
        ts.append(now)
        hosts.append((app.host_out, s))
        if i in picks:
            kept.append((out, s))
        last.append((out, s))
        i += 1
        if now >= end:
            break
    ctx.sync()
    ts[-1] = time.perf_counter()
    ticks = np.diff(ts)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    # the app's own spans, kept through the window as the app keeps them
    # (it never resets its timer after the warm-up), read after it
    spans = collections.defaultdict(float)
    for name, ms in app.timer.spans():
        spans[name] += ms / i
    app.timer.reset()

    rec = dict(setup_s=setup_s, window_s=ts[-1] - ts[0], attempted=i,
               tick_s=ticks, spans=dict(spans), peak_bytes=peak, trace=None,
               frames_per_s=i / (ts[-1] - ts[0]))
    if ctx.trace:
        rec["trace"] = trace.traced(tick, int(tr["trace_ticks"]), ctx.tmpdir,
                                    sync=ctx.sync)
    compared = [(fr.to_host(o), s) for o, s in list(kept) + list(last)]
    mat = app.calibrated_plane.get_mat().cpu().numpy()
    events = [tuple(m) for _, m in app.midi.sink.events]
    consumed = [(first + j) % n for j in range(state["k"] - 1 - first)]
    del app, model, out, kept, last
    fr.free_program()

    t_ref = time.perf_counter()
    ref, work, ref_mat = fr.reference(ctx, scenes, first % n)
    checks = compare.Checks(ctx.workload["limits"])
    checks.answer(plane_off=compare.max_abs_off(mat, ref_mat))
    for o, s in compared:
        checks.answer(**compare.frame_readings(o, ref[s]))
    for h, s in hosts:
        checks.answer(**compare.host_readings(h, ref[s]))
    want = taps.replay([ref[s]["heights"] for s in consumed],
                       [ref[s]["tip_valid"] for s in consumed], cfg["app"])
    checks.answer(midi_off=compare.events_off(events, want))
    rec.update(checks=checks, reference_s=time.perf_counter() - t_ref,
               midi_events=len(events),
               ops_per_frame=float(np.mean([fr.frame_ops(cfg, w, 1)
                                            for w in work])))
    return rec

