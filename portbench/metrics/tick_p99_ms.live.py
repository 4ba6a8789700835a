"""tick_p99_ms.live: the 99th percentile of every tick-to-tick time of the
window (a tick from its start to the next one's; the last to the
synchronise), stalls included, in ms."""

import numpy as np


def read(rec):
    if "tick_s" not in rec:
        return None
    return float(np.percentile(rec["tick_s"], 99)) * 1e3
