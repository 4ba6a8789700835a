"""live_ms_per_frame: the window's seconds over the ticks completed in it
(host clock, the window closed by a synchronise), in ms."""


def read(rec):
    if "tick_s" not in rec:
        return None
    return rec["window_s"] / rec["attempted"] * 1e3
