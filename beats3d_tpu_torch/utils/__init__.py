from .profiler import ProfileTimer
from .intrinsics import CameraIntrinsics
from .logging import get_logger

__all__ = ["ProfileTimer", "CameraIntrinsics", "get_logger"]
