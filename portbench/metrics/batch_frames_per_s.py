"""batch_frames_per_s: the frames of every call completed in the window
(each with its host read) over the window's seconds."""


def read(rec):
    if "batch" not in rec:
        return None
    return rec["attempted"] * rec["batch"] / rec["window_s"]
