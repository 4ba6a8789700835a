"""device_ms.batch: the device's busy time (the union over its streams) per
batched call of the traced window, in ms."""


def read(rec):
    t = rec.get("trace")
    if t is None or "batch" not in rec:
        return None
    return t["busy_s"] / t["calls"] * 1e3
