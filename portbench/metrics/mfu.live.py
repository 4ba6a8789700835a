"""mfu.live: the model's float32 operations per frame (K1's walk counted by
the reference, K2's 114 a pixel) times the window's frames per second,
over the card's 67 TFLOP/s, in %."""

from portbench.work import counts


def read(rec):
    if "ops_per_frame" not in rec or "tick_s" not in rec:
        return None
    return rec["ops_per_frame"] * rec["frames_per_s"] / counts.F32_OPS_PER_S \
        * 100.0
