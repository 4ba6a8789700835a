"""aten_elementwise_ms.batch: device ms per batched call of the traced
window in the ``fusion_other`` stage (ATen's elementwise kernels)."""


def read(rec):
    t = rec.get("trace")
    if t is None or "batch" not in rec:
        return None
    return t["stages"].get("fusion_other", [0.0, 0])[0] / t["calls"]
