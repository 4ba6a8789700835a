"""The 3d-beats application core, headless (counterpart of
beats3d_tpu/runtime/app.py).

Camera frames in, MIDI note events out.  The per-frame compute is
:class:`..runtime.pipeline.FramePipeline` on the model's device; this module
owns the host state: plane calibration policy, camera warm-up, tap state
machines, MIDI and profiling.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..models.layered import LayeredDecisionForest
from ..ops import plane as plane_ops
from ..ops import points
from ..utils.profiler import FrameTimeLog, ProfileTimer
from .hand_state import HandState
from .midi import Midi
from .pipeline import FramePipeline, PipelineConfig


@dataclasses.dataclass
class AppConfig:
    """Host-side tunables (reference 3d_bz.py:49-124)."""

    labels_reduce: int = 2
    plane_num_iterations: int = 25000
    plane_z_outlier_threshold: float = 40.0
    gauss_sigma: float = 2.0
    z_thresh_offset: float = 25.0
    min_velocity: float = 10.0
    velocity_sensitive: bool = True
    max_velocity: float = 120.0
    group_min_size: float = 0.06
    mean_shift_rounds: int = 6
    warmup_frames: int = 10
    default_fingertip_thresholds: tuple = (200.0, 160.0, 160.0, 160.0, 160.0)
    midi_base_notes: tuple = (36, 41)  # right, left (3d_bz.py:116-124)
    # tick() runs frame N and feeds frame N-1's results to the tap state
    # machines, so MIDI events trail the camera by one frame, as in the JAX
    # application.
    pipelined: bool = True


class BeatsApp:
    """Live 2-hand 10-finger MIDI instrument (the reference's 3d_bz app)."""

    def __init__(
        self,
        model: LayeredDecisionForest,
        source,
        midi: Optional[Midi] = None,
        cfg: Optional[AppConfig] = None,
        log=print,
    ):
        self.cfg = cfg or AppConfig()
        self.source = source
        self.intrin = source.intrinsics
        self.model = model
        self.device = model.device
        self.midi = midi or Midi()
        self.log = log

        pcfg = PipelineConfig(
            height=self.intrin.height,
            width=self.intrin.width,
            labels_reduce=self.cfg.labels_reduce,
            gauss_sigma=self.cfg.gauss_sigma,
            mean_shift_rounds=self.cfg.mean_shift_rounds,
        )
        self.pipeline = FramePipeline(
            model,
            self.intrin,
            cfg=pcfg,
            plane_z_threshold=self.cfg.plane_z_outlier_threshold,
            group_min_size=self.cfg.group_min_size,
        )
        self.calibrated_plane = plane_ops.CalibratedPlane(
            self.cfg.plane_num_iterations,
            self.cfg.plane_z_outlier_threshold,
            device=self.device,
        )
        self.calibrate_next_frame = False

        on_fn = lambda n, v: self.midi.send([0x90, n, v])
        off_fn = lambda n: self.midi.send([0x80, n, 0])
        make = lambda base: [
            (self.cfg.default_fingertip_thresholds[i], base + i)
            for i in range(5)
        ]
        self.hand_states = [
            HandState(make(self.cfg.midi_base_notes[0]), on_fn, off_fn, is_rh=True),
            HandState(make(self.cfg.midi_base_notes[1]), on_fn, off_fn, is_rh=False),
        ]

        self.timer = ProfileTimer()
        self.frame_times = FrameTimeLog()
        self.frame_num = 0
        self.last_out = None
        self._pending = None  # previous frame's output (pipelined mode)

    # -- per-frame ------------------------------------------------------------
    def tick(self, frame) -> Optional[dict]:
        self.frame_times.tick()
        self.timer.record("upload")
        depth = self.pipeline.as_depth(frame.depth)

        if self.frame_num < self.cfg.warmup_frames:
            self.frame_num += 1
            self.timer.reset()
            return None

        if not self.calibrated_plane.is_set() or self.calibrate_next_frame:
            self.timer.record("plane calibration")
            pts = points.deproject_points(depth, self.pipeline.pp,
                                          self.pipeline.fx)
            start = (
                self.calibrated_plane.get_mat()
                if self.calibrated_plane.is_set()
                else None
            )
            self.calibrated_plane.make(pts, start_mat=start)
            self.calibrate_next_frame = False

        # live tunables that feed the device program
        self.pipeline.group_min_size = self.cfg.group_min_size

        self.timer.record("frame_step")
        out = self.pipeline(depth, self.calibrated_plane.get_mat())

        if self.cfg.pipelined:
            # Consume the PREVIOUS frame's results.
            out, self._pending = self._pending, out
            self.frame_num += 1
            if out is None:
                self.timer.stop()
                return None

        self.timer.record("host update")
        self._host_update(out)
        self.timer.stop()

        if not self.cfg.pipelined:
            self.frame_num += 1
        self.last_out = out
        return out

    def _host_update(self, out):
        """Tap state machines + MIDI from one frame's outputs, fetched to
        the host in one copy."""
        both = torch.cat([out["heights"], out["tip_valid"].to(torch.float32)])
        both = both.cpu().numpy()
        heights, valid = both[:2], both[2:] != 0
        for hand_idx in range(2):
            # propagate live tunables BEFORE the tap update (3d_bz.py:505-507)
            for f in self.hand_states[hand_idx].fingertips:
                f.velocity_sensitive = self.cfg.velocity_sensitive
                f.min_velocity = self.cfg.min_velocity
                f.max_velocity = self.cfg.max_velocity
            self.hand_states[hand_idx].update(
                heights[hand_idx], valid[hand_idx], self.cfg.z_thresh_offset,
            )

    def flush(self) -> Optional[dict]:
        """Drain the pending frame (pipelined mode) at stream end."""
        out, self._pending = self._pending, None
        if out is not None:
            self._host_update(out)
            self.last_out = out
        return out

    def recalibrate_plane(self):
        """The reference's 'recalibrate plane' button (3d_bz.py:339)."""
        self.calibrate_next_frame = True

    def reset_fingers(self):
        """The reference's 'reset fingers' button (3d_bz.py:333-336)."""
        for h in self.hand_states:
            for f, t in zip(h.fingertips, self.cfg.default_fingertip_thresholds):
                f.z_thresh = t

    def labels_rgba(self) -> Optional[np.ndarray]:
        """Debug render: composite both hands' label images to RGBA."""
        if self.last_out is None:
            return None
        labels = self.last_out["labels"]
        rgba = points.make_rgba_from_labels(labels[0], self.model.label_colors)
        rgba2 = points.make_rgba_from_labels(labels[1], self.model.label_colors)
        rgba, rgba2 = rgba.cpu().numpy(), rgba2.cpu().numpy()
        return np.where(rgba[..., 3:] > 0, rgba, rgba2)

    # -- main loop --------------------------------------------------------------
    def run(self, max_frames: int = 0):
        n = 0
        try:
            for frame in self.source.frames():
                self.tick(frame)
                n += 1
                if max_frames and n >= max_frames:
                    break
            self.flush()
        finally:
            self.source.stop()
        return n
