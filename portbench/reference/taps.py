"""Per-finger tap state machines: the benchmark's reference for the MIDI
events the instrument sends (a frozen copy of beats3d_tpu_torch/runtime/
hand_state.py, reference 3d-beats src/hand_state.py:4-86), and the replay
of a sequence of fingertip heights through them.  Host only; imports
nothing of the program.
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


def replay(heights, valid, app: dict):
    """The MIDI messages (tuples) that ``app``'s tap state machines send for
    a sequence of frames' (2, F) heights and tip_valid, fed in order: the
    configuration file's ``app`` section gives the thresholds, notes and
    velocity settings."""
    events = []
    on_fn = lambda n, v: events.append((0x90, n, v))
    off_fn = lambda n: events.append((0x80, n, 0))
    thr = app["default_fingertip_thresholds"]
    hands = [HandState([(thr[i], base + i) for i in range(5)], on_fn, off_fn,
                       is_rh=(k == 0))
             for k, base in enumerate(app["midi_base_notes"])]
    for h, v in zip(heights, valid):
        for k in range(2):
            for f in hands[k].fingertips:
                f.velocity_sensitive = app["velocity_sensitive"]
                f.min_velocity = app["min_velocity"]
                f.max_velocity = app["max_velocity"]
            hands[k].update(h[k], v[k], app["z_thresh_offset"])
    return events
