"""heights_ms.batch: device ms per replay of the batched call's frame program
(``frame_step_batched``) in its ``heights`` stage, from the program's stage
stamps (the registry that ``beats3d_tpu_torch.utils.profiler.stage_ms``
reads), over every replay of the run."""

from portbench.lib import stages


def read(rec):
    if "batch" not in rec:
        return None
    return stages.stage_ms("frame_step_batched", "heights")
