from .profiler import ProfileTimer
from .intrinsics import CameraIntrinsics

__all__ = ["ProfileTimer", "CameraIntrinsics"]
