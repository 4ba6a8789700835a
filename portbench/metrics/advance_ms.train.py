"""advance_ms.train: host ms per traced candidate tree inside the trainer's
``train.advance`` ranges (the pixels moved to the next level)."""


def read(rec):
    t = rec.get("trace")
    if t is None or "trees" not in rec:
        return None
    r = t["ranges"].get("train.advance")
    return None if r is None else r[0] * 1e3 / t["calls"]
