"""train_s_per_tree: the window's seconds (from a candidate tree's start to
the first tree boundary after the window's length) over the candidate trees
completed in it, each with its held-out scoring."""


def read(rec):
    if "trees" not in rec:
        return None
    return rec["window_s"] / rec["attempted"]
