"""idle_share.live: the share of the window in which no device operation
ran, in %: 1 - (the device's busy time per call in the traced window, the
union over its streams) x (the calls per second of the untraced window).
The traced window's own wall is not used: the profiler slows the host
(CUPTI instruments every node of a graph launch), so its idle share
overstates the untraced run's."""


def read(rec):
    t = rec.get("trace")
    if t is None or not rec.get("window_s"):
        return None
    busy_per_call = t["busy_s"] / t["calls"]
    return (1.0 - busy_per_call * rec["attempted"] / rec["window_s"]) * 100.0
