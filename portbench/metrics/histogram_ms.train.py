"""histogram_ms.train: host ms per traced candidate tree inside the trainer's
``train.histogram`` ranges (B4 and the histograms over the image blocks)."""


def read(rec):
    t = rec.get("trace")
    if t is None or "trees" not in rec:
        return None
    r = t["ranges"].get("train.histogram")
    return None if r is None else r[0] * 1e3 / t["calls"]
