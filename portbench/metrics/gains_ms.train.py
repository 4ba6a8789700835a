"""gains_ms.train: host ms per traced candidate tree inside the trainer's
``train.gains`` ranges (``pick_best_step``)."""


def read(rec):
    t = rec.get("trace")
    if t is None or "trees" not in rec:
        return None
    r = t["ranges"].get("train.gains")
    return None if r is None else r[0] * 1e3 / t["calls"]
