"""host_update_ms.live: the mean of BeatsApp.timer's ``host update`` span per
tick of the window: the wait for the previous frame's copy, the tap state
and MIDI."""


def read(rec):
    return rec.get("spans", {}).get("host update")
