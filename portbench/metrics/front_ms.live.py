"""front_ms.live: device ms per replay of the live tick's frame program
(``frame_step``) in its ``front`` stage, from the program's stage stamps
(the registry that ``beats3d_tpu_torch.utils.profiler.stage_ms`` reads),
over every replay of the run."""

from portbench.lib import stages


def read(rec):
    if "tick_s" not in rec:
        return None
    return stages.stage_ms("frame_step", "front")
