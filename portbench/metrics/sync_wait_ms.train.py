"""sync_wait_ms.train: host ms per traced candidate tree inside the trainer's
``train.sync`` ranges: the calls that make the host wait for the card
(copies, ``nonzero``, boolean-mask indexing, ``bincount``)."""


def read(rec):
    t = rec.get("trace")
    if t is None or "trees" not in rec:
        return None
    r = t["ranges"].get("train.sync")
    return None if r is None else r[0] * 1e3 / t["calls"]
