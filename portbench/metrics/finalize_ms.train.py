"""finalize_ms.train: host ms per candidate tree inside the trainer's
``finalize`` ranges (the per-level write-out), in the traced tree."""


def read(rec):
    t = rec.get("trace")
    if t is None or "trees" not in rec:
        return None
    r = t["ranges"].get("finalize")
    return None if r is None else r[0] * 1e3 / t["calls"]
