"""b4_roofline.train: B4's least time over the traced candidate tree (each
launch's bytes and operations from its shape, proposals and active pixels,
at the card's peaks) over B4's traced device time, in %."""


def read(rec):
    t = rec.get("trace")
    if t is None or not rec.get("b4_bound_s"):
        return None
    ms = sum(v[0] for k, v in t["per_op"].items()
             if "train_feature_bits" in k)
    if ms <= 0:
        return None
    return rec["b4_bound_s"] / (ms / 1e3) * 100.0
