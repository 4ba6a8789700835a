"""enqueue_ms.live: the mean of BeatsApp.timer's ``frame_step`` span per
tick of the window: the frame program's enqueue (graph replay)."""


def read(rec):
    return rec.get("spans", {}).get("frame_step")
