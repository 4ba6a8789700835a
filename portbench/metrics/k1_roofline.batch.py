"""k1_roofline.batch: K1's least time per batched call (its bytes and
operations counted from the reference's walk on the call's inputs, at the
card's peaks) over K1's traced device time per call, in %."""


def read(rec):
    t = rec.get("trace")
    if t is None or "k1_bound_s" not in rec:
        return None
    ms = sum(v[0] for k, v in t["per_op"].items()
             if "evaluate_layered" in k)
    if ms <= 0:
        return None
    return rec["k1_bound_s"] * t["calls"] / (ms / 1e3) * 100.0
