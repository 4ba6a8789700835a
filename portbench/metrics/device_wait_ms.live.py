"""device_wait_ms.live: the mean of BeatsApp.timer's ``wait`` span per tick
of the window: the host waiting for the previous frame's copy to arrive
(inside ``host update``).  None where the program has no such span."""


def read(rec):
    return rec.get("spans", {}).get("wait")
