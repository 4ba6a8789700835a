"""mfu.batch: the model's float32 operations per batched call (K1's walk on
the call's crops and rescued frames, counted by the reference, K2's 114 a
pixel) times the window's calls per second, over the card's 67 TFLOP/s,
in %."""

from portbench.work import counts


def read(rec):
    if "ops_per_call" not in rec:
        return None
    return rec["ops_per_call"] * rec["calls_per_s"] / counts.F32_OPS_PER_S \
        * 100.0
