"""syncs_per_tree.train: the trainer's ``train.sync`` ranges per traced
candidate tree: its calls that make the host wait for the card (a
``bincount`` waits more than once inside its one range)."""


def read(rec):
    t = rec.get("trace")
    if t is None or "trees" not in rec:
        return None
    r = t["ranges"].get("train.sync")
    return None if r is None else r[1] / t["calls"]
