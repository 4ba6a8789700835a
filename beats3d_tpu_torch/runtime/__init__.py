from .pipeline import FramePipeline, PipelineConfig
from .hand_state import FingertipState, HandState

__all__ = ["FramePipeline", "PipelineConfig", "FingertipState", "HandState"]
