"""The comparison that decides ``correct``: the program's outputs against
the reference's, as numbers each held to a limit from the cell's workload
file (``limits``).  Host numpy; imports nothing of the program.
"""

from __future__ import annotations

import numpy as np


class Checks:
    """Running worst readings of each compared number, and the count of
    compared answers that broke a limit."""

    def __init__(self, limits: dict):
        self.limits = dict(limits)
        self.value = {k: 0.0 for k in limits}
        self.answers = 0
        self.failed = 0

    def answer(self, **readings):
        """One compared answer's readings (a subset of the limits' names):
        each raises its number's worst reading; the answer fails when any
        reading is above its limit."""
        self.answers += 1
        bad = False
        for k, v in readings.items():
            v = float(v)
            if not np.isfinite(v):
                v = float("inf")
            self.value[k] = max(self.value[k], v)
            bad |= v > self.limits[k]
        self.failed += bad

    def answers_many(self, **readings):
        """Many answers at once: each reading an array with one entry per
        answer."""
        arrs = {k: np.asarray(v, np.float64) for k, v in readings.items()}
        n = len(next(iter(arrs.values())))
        bad = np.zeros(n, bool)
        for k, v in arrs.items():
            v = np.where(np.isfinite(v), v, np.inf)
            if n:
                self.value[k] = max(self.value[k], float(v.max()))
            bad |= v > self.limits[k]
        self.answers += n
        self.failed += int(bad.sum())

    @property
    def correct(self) -> bool:
        return self.answers > 0 and self.failed == 0 and all(
            self.value[k] <= self.limits[k] for k in self.limits)

    def table(self) -> dict:
        return {k: {"value": self.value[k], "limit": self.limits[k]}
                for k in self.limits}


def count_off(a, b) -> int:
    """Elements that differ (shapes must agree, else every element)."""
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape:
        return max(a.size, b.size)
    return int(np.sum(a.astype(np.int64) != b.astype(np.int64)))


def max_abs_off(a, b) -> float:
    """Largest |a - b|; NaN where the other is not NaN counts infinite."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.shape != b.shape:
        return float("inf")
    na, nb = np.isnan(a), np.isnan(b)
    if (na != nb).any():
        return float("inf")
    d = np.abs(np.where(na, 0.0, a) - np.where(nb, 0.0, b))
    return float(d.max()) if d.size else 0.0


def heights_rel(h, valid, ref_h, ref_valid) -> float:
    """Largest |h - ref| / max(|ref|, 1) over the tips valid on both
    sides (a tip valid on one side only is ``tips_off``'s)."""
    h = np.asarray(h, np.float64)
    r = np.asarray(ref_h, np.float64)
    both = np.asarray(valid, bool) & np.asarray(ref_valid, bool)
    if not both.any():
        return 0.0
    d = np.abs(h[both] - r[both]) / np.maximum(np.abs(r[both]), 1.0)
    return float(d.max()) if np.isfinite(d).all() else float("inf")


def frame_readings(out: dict, ref: dict) -> dict:
    """The numbers of one frame's outputs against the reference's: labels
    that differ, the largest mode gap, the largest relative height gap,
    the fingertip flags that differ (tip_valid and the guard's mute
    flags), and the largest gap in the hand groups' sizes and centres
    (``g_info``: the grouping of K2's banded, filtered depth, which places
    the crops).  The plane is compared once a run (``plane_off``)."""
    return dict(
        labels_off=count_off(out["labels"], ref["labels"]),
        groups_off=max_abs_off(out["g_info"], ref["g_info"]),
        means_off=max_abs_off(out["means"], ref["means"]),
        heights_rel=heights_rel(out["heights"], out["tip_valid"],
                                ref["heights"], ref["tip_valid"]),
        tips_off=(count_off(out["tip_valid"], ref["tip_valid"])
                  + count_off(out["guard_muted"], ref["guard_muted"])))


def host_readings(host: dict, ref: dict) -> dict:
    """The numbers of the live tick's host read (heights, tip_valid,
    guard_muted) against the reference's."""
    return dict(heights_rel=heights_rel(host["heights"], host["tip_valid"],
                                        ref["heights"], ref["tip_valid"]),
                tips_off=(count_off(host["tip_valid"], ref["tip_valid"])
                          + count_off(host["guard_muted"],
                                      ref["guard_muted"])))


def events_off(got, want) -> int:
    """MIDI messages that differ position by position, plus the difference
    in their numbers."""
    n = min(len(got), len(want))
    return (sum(tuple(a) != tuple(b) for a, b in zip(got[:n], want[:n]))
            + abs(len(got) - len(want)))


def host_block_readings(h, v, ref_h, ref_v):
    """Per answer (leading axis) of stacked host reads: heights (N, ...)
    and tip_valid against the reference's of the same shapes.  Returns
    arrays heights_rel and tips_off."""
    h, r = np.asarray(h, np.float64), np.asarray(ref_h, np.float64)
    v, rv = np.asarray(v, bool), np.asarray(ref_v, bool)
    n = h.shape[0]
    both = v & rv
    rel = np.where(both, np.abs(h - r) / np.maximum(np.abs(r), 1.0), 0.0)
    rel = np.where(np.isnan(rel), np.inf, rel)
    return dict(heights_rel=rel.reshape(n, -1).max(axis=1),
                tips_off=(v != rv).reshape(n, -1).sum(axis=1))
