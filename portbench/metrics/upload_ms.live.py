"""upload_ms.live: the mean of BeatsApp.timer's ``upload`` span per tick of
the window: the frame's copy to the card through pinned memory
(``PinnedUpload``)."""


def read(rec):
    return rec.get("spans", {}).get("upload")
