# Copied from beats3d_tpu/runtime/hand_state.py (numpy / host only).
"""Per-finger tap-detection state machines + MIDI gating (host side).

Reference: src/hand_state.py:4-86.  This logic is tiny, stateful, and
latency-critical in its ordering with MIDI emission, so it stays host-side
Python by design (the TPU pipeline hands it one (hands, fingers) float array
per frame).

Semantics preserved:
* a note fires when the fingertip is below ``z_thresh + z_thresh_offset`` AND
  the last two frame-to-frame downward velocities both exceed ``min_velocity``
  (hand_state.py:38-51);
* velocity-sensitive mode maps mean tap velocity into MIDI velocity with a
  floor of ``min_midi_velocity`` (hand_state.py:44-48);
* the note releases when the fingertip rises above threshold, and on release
  the threshold self-calibrates by EWMA (alpha 0.1) toward the average held
  height when enough samples exist (hand_state.py:58-75);
* a fingertip that leaves the image resets its history and releases
  (hand_state.py:26-30, 3d_bz.py:512-513).
"""

from __future__ import annotations

from typing import Callable, List, Sequence


class FingertipState:
    def __init__(
        self,
        on_fn: Callable[[int, int], None],
        off_fn: Callable[[int], None],
        num_positions: int = 40,
        z_thresh: float = 150.0,
        midi_note: int = 36,
    ):
        self.num_positions = num_positions
        self.positions: List[float] = [0.0] * num_positions
        self.on_positions: List[float] = []
        self.on_fn = on_fn
        self.off_fn = off_fn
        self.z_thresh = z_thresh
        self.midi_note = midi_note
        self.note_on = False

        self.calibrate_alpha = 0.1
        self.min_velocity = 15.0
        self.velocity_sensitive = True
        self.max_velocity = 150.0
        self.min_midi_velocity = 0.4  # out of 1

    def reset_positions(self):
        self.positions = [0.0] * self.num_positions
        self.set_midi_state(False)

    def next_z_pos(self, z_pos: float, z_thresh_offset: float):
        self.positions.append(z_pos)
        while len(self.positions) > self.num_positions:
            self.positions.pop(0)

        if len(self.positions) > 10:
            if z_pos < (self.z_thresh + z_thresh_offset):
                v1 = self.positions[-2] - self.positions[-1]
                v2 = self.positions[-3] - self.positions[-2]
                if v1 > self.min_velocity and v2 > self.min_velocity:
                    if self.velocity_sensitive:
                        v = ((v1 + v2) / 2.0) / (self.max_velocity - self.min_velocity)
                        v = self.min_midi_velocity + v * (1.0 - self.min_midi_velocity)
                        v = min(v, 1.0)
                    else:
                        v = 1.0
                    self.set_midi_state(True, v)
            else:
                self.set_midi_state(False, 0.0)

        if self.note_on:
            self.on_positions.append(z_pos)

    def set_midi_state(self, s: bool, vel: float = 1.0):
        if s and not self.note_on:
            self.note_on = True
            self.on_fn(self.midi_note, int(vel * 127))
            self.on_positions.clear()
        elif not s and self.note_on:
            self.note_on = False
            self.off_fn(self.midi_note)
            if len(self.on_positions) >= 4:
                # average held height, trimming first & last samples
                on_z = sum(self.on_positions[1:-1]) / (len(self.on_positions) - 2.0)
                if on_z > 70.0:  # sanity floor before self-calibrating
                    self.z_thresh = (
                        (1.0 - self.calibrate_alpha) * self.z_thresh
                        + self.calibrate_alpha * on_z
                    )
            self.on_positions.clear()


class HandState:
    """Five fingertips of one hand (reference hand_state.py:78-86)."""

    def __init__(
        self,
        defaults: Sequence,
        on_fn,
        off_fn,
        is_rh: bool = True,
        num_positions: int = 50,
    ):
        self.is_rh = is_rh
        self.fingertips = [
            FingertipState(on_fn, off_fn, num_positions, z_thresh, midi_note)
            for z_thresh, midi_note in defaults
        ]

    def update(self, heights, valid, z_thresh_offset: float):
        """Feed one frame of per-finger heights (from the TPU pipeline)."""
        for f, h, ok in zip(self.fingertips, heights, valid):
            if not ok:
                f.reset_positions()
            else:
                f.next_z_pos(float(h), z_thresh_offset)
