"""Play the instrument on an articulated tapping session (counterpart of
the repository's ``scripts/bz3d_session_v2.py``): articulated frames ->
labels -> mean-shift tips -> tap state machines -> MIDI note events.

The session: two articulated hands whose height above the table
oscillates (fingers mostly extended), so the fingertip heights sweep
through the tap thresholds and the HandState machines emit note on/offs,
on the geometry family the model was trained on.  The hands come from
seed 5; the app is ``runtime.app.BeatsApp`` with the committed flagship
(``run_session`` takes any model, such as its serving-depth variant from
``models.load_serving_flagship``).

    python -m beats3d_tpu_torch.scripts.bz3d_session_v2 [frames]

Runs on the card.  Appends the session's record to ``RESULTS.json`` under
``B3D_V2_OUT`` (default ``build/flagship_v2``, where
``scripts.flagship_v2`` writes; the file is made if absent).
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

from ..data.synth import compose, hand_cloud, splat_hand, table_depth
from ..runtime.app import AppConfig, BeatsApp
from ..runtime.camera import Frame
from ..runtime.midi import Midi
from ..models import load_flagship
from ..utils import CameraIntrinsics
from . import flagship_v2 as v2
from . import resolve_device

SEED = 5


def session_frames(intrin, n_frames):
    """The session's depth frames: the two hands' shapes are fixed for the
    whole session (seed 5), their heights bounce 120..260 units above the
    table, so the fingertip heights cross the ~150-200 thresholds each
    cycle."""
    tz = table_depth(intrin)
    rng = np.random.default_rng(SEED)
    right, rcols = hand_cloud(rng, flex_scale=0.25)
    left, lcols = hand_cloud(rng, flex_scale=0.25)
    frames = []
    for t in range(n_frames):
        h_r = 190.0 + 70.0 * np.sin(t / 7.0)
        h_l = 190.0 + 70.0 * np.sin(t / 9.0 + 1.3)
        layers = [
            splat_hand(intrin, tz, right, rcols, 0.30 * intrin.width,
                       0.55 * intrin.height, h_r, 0.1),
            splat_hand(intrin, tz, left, lcols, 0.70 * intrin.width,
                       0.55 * intrin.height, h_l, -0.1, mirror=True),
        ]
        depth, _ = compose(tz, layers)
        frames.append(depth)
    return frames


class FramesSource:
    """A camera source replaying depth frames at 90 FPS timestamps."""

    def __init__(self, intrinsics, frames):
        self.intrinsics = intrinsics
        self._frames = frames

    def frames(self):
        for t, d in enumerate(self._frames):
            yield Frame(depth=d, timestamp=t / 90.0)

    def stop(self):
        pass


def app_config():
    return AppConfig(plane_num_iterations=8192, warmup_frames=2,
                     min_velocity=2.0,
                     default_fingertip_thresholds=(170.0,) * 5)


def run_session(model, intrin, frames, *, plane=None, on_tick=None):
    """``frames`` through a BeatsApp on ``model``'s device.  ``plane``: a
    CalibratedPlane to calibrate with in place of the app's own (the same
    uniforms as another run); ``on_tick``: called with each tick's output
    (None in warm-up and, pipelined, on the first frame).  Returns (the
    session's record, the app)."""
    app = BeatsApp(model, FramesSource(intrin, frames), midi=Midi(),
                   cfg=app_config(), log=lambda *a: None)
    if plane is not None:
        app.calibrated_plane = plane
    if on_tick is not None:
        tick = app.tick
        app.tick = lambda frame: on_tick(tick(frame))
    t0 = time.time()
    n = app.run(max_frames=len(frames))
    dt = time.time() - t0
    events = app.midi.sink.note_events()
    ons = [e for e in events if e[1] == "on"]
    labels_out = app.last_out["labels"].cpu().numpy()
    hist = {int(k): int(v) for k, v in
            zip(*np.unique(labels_out, return_counts=True))}
    rec = {
        "frames": int(n),
        "fps": round(n / dt, 1),
        "note_ons": len(ons),
        "note_events": len(events),
        "label_histogram": {str(k): v for k, v in sorted(hist.items())},
        "scene": "articulated bouncing hands (data/synth.py)",
        "note": "session fps includes the kernels' first use and the "
                "frame graphs' capture",
    }
    return rec, app


def main(argv=None, device=None):
    """The session on the card (``device``: another device) with the
    committed flagship.  Returns the record."""
    argv = sys.argv[1:] if argv is None else list(argv)
    device = resolve_device(device)
    n_frames = int(argv[0]) if argv else 120
    intrin = CameraIntrinsics.d415()
    print(f"[session] pre-rendering {n_frames} articulated frames...",
          flush=True)
    t0 = time.time()
    frames = session_frames(intrin, n_frames)
    print(f"[session] rendered in {time.time() - t0:.0f}s", flush=True)
    rec, _ = run_session(load_flagship(device), intrin, frames)
    print(json.dumps(rec), flush=True)

    os.makedirs(v2.OUT, exist_ok=True)
    path = os.path.join(v2.OUT, "RESULTS.json")
    summary = {}
    if os.path.exists(path):
        with open(path) as f:
            summary = json.load(f)
    summary["bz3d_session"] = rec
    with open(path, "w") as f:
        json.dump(summary, f, indent=1)
    print("appended bz3d_session to", path, flush=True)
    return rec


if __name__ == "__main__":
    main()
