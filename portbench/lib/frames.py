"""What the frame cells (the live tick and the batched call) share: the
program's model and pipeline settings from the configuration file, the
outputs they compare, and the reference's outputs and work counts for the
cell's scenes.
"""

from __future__ import annotations

import gc

import numpy as np
import torch

from ..reference import frame, models, plane
from ..work import counts

KEYS = ("labels", "means", "heights", "tip_valid", "g_info", "guard_muted")


def to_host(out: dict) -> dict:
    """The compared outputs of one call, as numpy."""
    return {k: out[k].to(torch.int32 if k == "labels" else out[k].dtype)
            .cpu().numpy() for k in KEYS}


def pipeline_kwargs(cfg: dict, fields) -> dict:
    """The configuration's ``pipeline`` values of the program's
    ``PipelineConfig`` fields."""
    return {k: (tuple(v) if isinstance(v, list) else v)
            for k, v in cfg["pipeline"].items() if k in fields}


def check_pipeline(cfg: dict, pcfg) -> None:
    """Raise unless the program's pipeline configuration is the one the
    configuration file states."""
    import dataclasses
    got = dataclasses.asdict(pcfg)
    want = pipeline_kwargs(cfg, got)
    diff = {k: (got[k], v) for k, v in want.items() if got[k] != v}
    if diff or set(want) != set(got):
        raise RuntimeError(f"the program runs another configuration than "
                           f"the file states: {diff or set(got) ^ set(want)}")


def free_program():
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def reference(ctx, scenes: np.ndarray, calib_scene: int, *, batch=False):
    """The reference's outputs for the cell's scenes, after the program's
    state is freed: the plane from the calibrated plane's first uniforms
    and the calibration frame, then either every scene as the live tick
    computes it (``batch`` False: {scene: outputs}) or the scenes as one
    batch ({scene: outputs}); with the K1 work of one call (per launch:
    (stack shape, per-layer walk counts)) and the plane, (4, 4) numpy.
    The model is the configuration's reference model (``models``)."""
    cfg = ctx.config
    dev = ctx.device
    model, run_layered = models.load(cfg, ctx.root, dev)
    pc = cfg["plane"]
    cam = cfg["camera"]
    raw = torch.as_tensor(scenes.astype(np.int32)).to(dev)
    pts = frame.deproject_points(raw[calib_scene],
                                 np.array([cam["ppx"], cam["ppy"]],
                                          np.float32), cam["fx"])
    mat = plane.calibrate_plane(
        plane.draw_uniforms(pc["num_candidates"], pc["seed"], dev), pts,
        float(pc["threshold"]))
    ref = frame.RefPipeline(model, cam, cfg["pipeline"], dev,
                            run_layered=run_layered)
    outs, work = {}, []
    if batch:
        ref.visits = []
        o = ref.batch(raw, mat)
        work = launches(ref)
        for i in range(raw.shape[0]):
            outs[i] = {k: o[k][i].cpu().numpy() for k in KEYS}
    else:
        for i in range(raw.shape[0]):
            ref.visits = []
            o = ref.frame(raw[i], mat)
            work.append(launches(ref))
            outs[i] = {k: o[k].cpu().numpy() for k in KEYS}
    return outs, work, mat.cpu().numpy()


def launches(ref):
    """The K1 launches the reference's last call stands for, in order (the
    crops first, then any full-frame rescue): (stack shape, per-layer
    walk counts)."""
    return [(shape, [counts.walk_counts(v) for v in lv])
            for shape, lv in ref.visits]


def k1_work(cfg, call_launches):
    """(bytes, operations, bound seconds) of one call's K1 launches."""
    classes = [l["classes"] for l in cfg["layers"]]
    r = cfg["pipeline"]["labels_reduce"]
    tot_b = tot_o = tot_s = 0.0
    for shape, layer_counts in call_launches:
        b, o = counts.k1_work(shape, layer_counts, classes,
                              cfg["condition_rows"], r)
        tot_b += b
        tot_o += o
        tot_s += counts.bound_s(b, o)[0]
    return tot_b, tot_o, tot_s


def frame_ops(cfg, call_launches, frames: int) -> float:
    """The model's float32 operations in one call of ``frames`` frames: K1's
    walk (from the reference's visits) and K2's 114 a pixel."""
    cam = cfg["camera"]
    return (k1_work(cfg, call_launches)[1]
            + counts.k2_work(frames * cam["width"] * cam["height"])[1])
