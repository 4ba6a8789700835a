"""mfu.train: the trainer's float32 operations in the window over the
window's seconds, over the card's 67 TFLOP/s, in %.  The operations are
B4's split bits (10 per active pixel and proposal, counted from each
launch's inputs) and B1's held-out scoring walk (9 per pixel-level step and
C per leaf reached, counted by the reference's walk of the same trees);
the histograms count integers, and the gains (a few operations per node,
proposal and class) are left out.  Read in the traced run, whose window
counts B4's active pixels."""

from portbench.work import counts


def read(rec):
    if not rec.get("window_ops"):
        return None
    return rec["window_ops"] / rec["window_s"] / counts.F32_OPS_PER_S * 100.0
