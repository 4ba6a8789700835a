# Copied from beats3d_tpu/runtime/camera.py (numpy / host only).
"""Depth-frame sources (reference src/rs_util.py).

Three interchangeable sources behind one iterator interface:

* :class:`RealSenseSource` — live Intel RealSense D4xx stream or .bag playback
  (requires pyrealsense2; gated import).  Matches the reference's stream setup:
  0.1 mm depth units, 848x480@90 (or 424x240 with half_resolution), advanced-
  mode JSON tuning, non-realtime bag playback (rs_util.py:8-47).
* :class:`RecordedSource` — .npz recorded sessions (our hardware-free
  equivalent of .bag playback, the integration-test fixture; see
  :func:`record_session`).
* :class:`SyntheticSource` — procedurally generated table+hands scenes for
  demos, tests, and benchmarks without any recording.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np

from ..utils.intrinsics import CameraIntrinsics


@dataclasses.dataclass
class Frame:
    depth: np.ndarray  # (H, W) uint16, 0.1 mm units
    timestamp: float
    color: Optional[np.ndarray] = None  # (H, W, 3) uint8 when available
    # The color frame's own capture time (seconds); depth/color pairs whose
    # timestamps diverge are rejected by datagen (live_data_convert.py:306-317)
    color_timestamp: Optional[float] = None


def add_args(parser):
    """Shared camera CLI flags (reference rs_util.add_args:4-7, extended)."""
    parser.add_argument("--rs_bag", type=str, default=None,
                        help="RealSense .bag file to play back (needs pyrealsense2)")
    parser.add_argument("--rs_half_resolution", action="store_true",
                        help="424x240 live stream instead of 848x480")
    parser.add_argument("--session", type=str, default=None,
                        help=".npz recorded session to play back (hardware-free)")
    parser.add_argument("--synthetic", action="store_true",
                        help="Use the procedural synthetic depth source")
    parser.add_argument("--frames", type=int, default=0,
                        help="Stop after N frames (0 = unlimited)")


def open_source(args):
    """Build the frame source an app asked for."""
    if args.session:
        return RecordedSource(args.session)
    if getattr(args, "synthetic", False):
        w, h = (424, 240) if args.rs_half_resolution else (848, 480)
        return SyntheticSource(CameraIntrinsics.d415(w, h))
    if args.rs_bag:
        # The pure-python .bag demuxer (runtime/bagfile.py) is not ported
        # yet: .bag playback needs pyrealsense2 here.
        return RealSenseSource(
            bag=args.rs_bag, half_resolution=args.rs_half_resolution
        )
    return RealSenseSource(half_resolution=args.rs_half_resolution)


class RecordedSource:
    """Plays back an .npz session written by :func:`record_session`:
    arrays 'depth' (N, H, W) uint16, 'timestamps' (N,), scalars fx fy ppx ppy,
    optional 'color' (N, H, W, 3) uint8."""

    def __init__(self, path: str, loop: bool = False):
        data = np.load(path)
        self.depth = data["depth"]
        self.timestamps = data["timestamps"]
        self.color = data["color"] if "color" in data else None
        self.color_timestamps = (
            data["color_timestamps"] if "color_timestamps" in data else None
        )
        n, h, w = self.depth.shape
        self.intrinsics = CameraIntrinsics(
            width=w, height=h,
            fx=float(data["fx"]), fy=float(data["fy"]),
            ppx=float(data["ppx"]), ppy=float(data["ppy"]),
        )
        self.loop = loop

    def frames(self) -> Iterator[Frame]:
        while True:
            for i in range(self.depth.shape[0]):
                yield Frame(
                    depth=self.depth[i],
                    timestamp=float(self.timestamps[i]),
                    color=None if self.color is None else self.color[i],
                    color_timestamp=(
                        None if self.color_timestamps is None
                        else float(self.color_timestamps[i])
                    ),
                )
            if not self.loop:
                return

    def stop(self):
        pass


def record_session(path: str, frames, intrinsics: CameraIntrinsics):
    """Write a session .npz from an iterable of Frames."""
    depth = np.stack([f.depth for f in frames])
    ts = np.array([f.timestamp for f in frames])
    colors = [f.color for f in frames]
    kw = {}
    if all(c is not None for c in colors) and colors:
        kw["color"] = np.stack(colors)
    cts = [f.color_timestamp for f in frames]
    if all(t is not None for t in cts) and cts:
        kw["color_timestamps"] = np.array(cts)
    np.savez_compressed(
        path, depth=depth, timestamps=ts,
        fx=intrinsics.fx, fy=intrinsics.fy,
        ppx=intrinsics.ppx, ppy=intrinsics.ppy, **kw,
    )


class SyntheticSource:
    """Procedural table + two hands with tapping fingers; deterministic."""

    def __init__(self, intrinsics: CameraIntrinsics, table_depth=2600.0,
                 hand_height=300.0, seed: int = 0):
        self.intrinsics = intrinsics
        self.table_depth = table_depth
        self.hand_height = hand_height
        self._rng = np.random.default_rng(seed)
        self._t = 0

    def make_frame(self, t: int) -> np.ndarray:
        it = self.intrinsics
        h, w = it.height, it.width
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        n = np.array([0.03, -0.06, 1.0])
        n /= np.linalg.norm(n)
        depth = (
            self.table_depth
            - n[0] * (xx - it.ppx) * 4
            - n[1] * (yy - it.ppy) * 4
        ) / n[2]
        r = int(0.15 * w)
        for k, cx in enumerate((int(0.3 * w), int(0.72 * w))):
            cy = h // 2
            blob = (xx - cx) ** 2 + (yy - cy) ** 2 < r * r
            # fingers tap sinusoidally at different phases
            tap = 0.5 + 0.5 * np.sin(0.35 * t + k * 1.7)
            depth[blob] -= self.hand_height * (0.4 + 0.6 * tap)
        return depth.astype(np.uint16)

    def frames(self) -> Iterator[Frame]:
        t = 0
        while True:
            yield Frame(depth=self.make_frame(t), timestamp=t / 90.0)
            t += 1

    def stop(self):
        pass


class RealSenseSource:
    """Live camera / .bag playback via pyrealsense2 (reference rs_util.py)."""

    def __init__(self, bag: Optional[str] = None, half_resolution: bool = False,
                 config_json: Optional[str] = "hand_config.json",
                 align_color: bool = False):
        """``align_color`` reprojects the color stream into the depth
        camera's frame per pair (rs.align; live_data_convert.py:396-400) —
        required when color drives labeling (datagen)."""
        try:
            import pyrealsense2 as rs  # type: ignore
        except ImportError as e:  # pragma: no cover - hardware path
            raise RuntimeError(
                "pyrealsense2 not available; use --session or --synthetic"
            ) from e
        self._rs = rs
        self._align = rs.align(rs.stream.depth) if align_color else None
        self.pipeline = rs.pipeline()
        config = rs.config()
        if bag:
            config.enable_device_from_file(bag, repeat_playback=True)
            config.enable_stream(rs.stream.depth, rs.format.z16)
            config.enable_stream(rs.stream.color, rs.format.rgb8)
        else:
            wrapper = rs.pipeline_wrapper(self.pipeline)
            profile = config.resolve(wrapper)
            device = profile.get_device()
            if config_json:
                with open(config_json) as f:
                    rs.rs400_advanced_mode(device).load_json(f.read())
            device.first_depth_sensor().set_option(rs.option.depth_units, 0.0001)
            dim_x, dim_y = (424, 240) if half_resolution else (848, 480)
            config.enable_stream(rs.stream.depth, dim_x, dim_y, rs.format.z16, 90)
        profile = self.pipeline.start(config)
        if bag:
            profile.get_device().as_playback().set_real_time(False)
        dp = profile.get_stream(rs.stream.depth).as_video_stream_profile()
        i = dp.get_intrinsics()
        self.intrinsics = CameraIntrinsics(
            width=i.width, height=i.height, fx=i.fx, fy=i.fy,
            ppx=i.ppx, ppy=i.ppy,
        )

    def frames(self) -> Iterator[Frame]:  # pragma: no cover - hardware path
        while True:
            frames = self.pipeline.wait_for_frames()
            if self._align is not None and frames.get_color_frame():
                frames = self._align.process(frames)
            depth_frame = frames.get_depth_frame()
            if not depth_frame:
                continue
            color_frame = frames.get_color_frame()
            yield Frame(
                depth=np.asanyarray(depth_frame.get_data()),
                timestamp=depth_frame.get_timestamp() / 1000.0,
                color=(
                    np.asanyarray(color_frame.get_data())
                    if color_frame
                    else None
                ),
                color_timestamp=(
                    color_frame.get_timestamp() / 1000.0
                    if color_frame
                    else None
                ),
            )

    def stop(self):  # pragma: no cover - hardware path
        self.pipeline.stop()
