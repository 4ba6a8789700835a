"""setup_s: seconds from the process's start to the first timed call
(loading, the inputs, the kernels' build or load, warm-up and capture)."""


def read(rec):
    return rec.get("setup_s")
