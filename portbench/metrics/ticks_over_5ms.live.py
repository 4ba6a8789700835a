"""ticks_over_5ms.live: the share of the window's ticks that took more
than 5 ms (stalls of the host: over four times the device's work of a
tick), in %."""

import numpy as np


def read(rec):
    if "tick_s" not in rec or not len(rec["tick_s"]):
        return None
    return float(np.mean(np.asarray(rec["tick_s"]) > 5e-3)) * 100.0
