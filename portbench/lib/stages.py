"""The program's per-stage device time of its captured frame programs: the
registry of stage stamps that ``beats3d_tpu_torch.utils.profiler.stage_ms``
reads (ms per replay, over every replay of the process).  The drivers do
not pass it in the run's record: a metric reads it here, after the run."""


def stage_ms(program: str, stage: str):
    """Device ms per replay of ``program``'s ``stage``, or None where the
    program keeps no stamps or ran no replay of ``program``."""
    try:
        from beats3d_tpu_torch.utils.profiler import stage_ms as registry
    except ImportError:
        return None
    return registry().get(program, {}).get(stage)
