"""device_ms.live: the device's busy time (the union over its streams) per
tick of the traced window, in ms."""


def read(rec):
    t = rec.get("trace")
    if t is None or "tick_s" not in rec:
        return None
    return t["busy_s"] / t["calls"] * 1e3
