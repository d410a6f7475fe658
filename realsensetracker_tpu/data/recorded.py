"""Recorded-clip format (.rsc): the framework's record/replay path.

The reference records per-frame protobuf point clouds from the viewer
(rs_viewer.cpp:105-112) and replays them by glob pattern
(rs_replay_app.cpp:132-165, 219-225); the clouds carry per-point colors
looked up from the RealSense color stream (rs_driver.cpp:33-103). This
framework records IMAGES instead (the pipeline is image-native); a clip is
one binary .rsc file holding all frames, so replay is a single sequential
read that feeds the device-resident pipeline.

Layout v1 (depth-only, little-endian):
  magic  'RSCLIP01'                      8 bytes
  header int32[4]: num_frames, height, width, dtype(0=u16mm,1=f32m)
  intr   float32[4]: fx, fy, cx, cy
  stamps float64[num_frames]
  frames num_frames * H * W * (2 or 4) bytes

Layout v2 (optional color plane -- the RGB-D record path):
  magic  'RSCLIP02'
  header int32[4] as v1, then int32[2]: has_color, reserved
  intr / stamps / depth frames as v1
  colors num_frames * H * W * 3 uint8   (only if has_color)

When the native C++ codec (realsensetracker_tpu.native.clip_io) is built it
handles the (de)serialization; this module is the format owner and Python
fallback.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np

from realsensetracker_tpu.geometry import camera

MAGIC = b"RSCLIP01"
MAGIC2 = b"RSCLIP02"
DTYPE_U16_MM = 0  # uint16 millimeters (compact, RealSense/TUM-style)
DTYPE_F32_M = 1  # float32 meters


@dataclass
class Clip:
    depths: np.ndarray  # (F, H, W) float32 meters
    timestamps: np.ndarray  # (F,) float64 seconds
    intrinsics: camera.Intrinsics
    colors: np.ndarray | None = None  # (F, H, W, 3) uint8, or None

    def __len__(self) -> int:
        return self.depths.shape[0]

    @property
    def has_color(self) -> bool:
        return self.colors is not None

    def gray(self, i: int) -> np.ndarray:
        """Frame i's BT.601 luma in [0,1] float32 (requires color)."""
        from realsensetracker_tpu.data.tum import rgb_to_gray

        return rgb_to_gray(self.colors[i])


def write_clip(path: str, depths, timestamps, intr: camera.Intrinsics,
               dtype: int = DTYPE_U16_MM, colors=None) -> None:
    """Write a clip; v1 when colors is None, v2 with a color plane otherwise."""
    depths = np.asarray(depths, np.float32)
    timestamps = np.asarray(timestamps, np.float64)
    f_count, h, w = depths.shape
    assert timestamps.shape == (f_count,)
    if colors is not None:
        colors = _as_u8_colors(colors)
        assert colors.shape == (f_count, h, w, 3), colors.shape
    with open(path, "wb") as f:
        if colors is None:
            f.write(MAGIC)
            f.write(struct.pack("<iiii", f_count, h, w, dtype))
        else:
            f.write(MAGIC2)
            f.write(struct.pack("<iiiiii", f_count, h, w, dtype, 1, 0))
        f.write(struct.pack("<ffff", intr.fx, intr.fy, intr.cx, intr.cy))
        f.write(timestamps.tobytes())
        if dtype == DTYPE_U16_MM:
            mm = np.clip(np.round(depths * 1000.0), 0, 65535).astype("<u2")
            f.write(mm.tobytes())
        else:
            f.write(depths.astype("<f4").tobytes())
        if colors is not None:
            f.write(colors.tobytes())


def _as_u8_colors(colors) -> np.ndarray:
    colors = np.asarray(colors)
    if colors.dtype != np.uint8:
        colors = np.clip(np.round(colors * 255.0), 0, 255).astype(np.uint8)
    return np.ascontiguousarray(colors)


def read_clip(path: str) -> Clip:
    """Read a clip: native codec when its library is available, else the
    Python fallback. Only the native toolchain's ABSENCE selects the
    fallback -- a real read error (truncated file, bad magic) propagates
    from whichever path ran, instead of being masked by a second full read
    that dies with an unrelated error."""
    if _native_clip_io() is not None:
        return _native_clip_io().read_clip(path)
    return read_clip_py(path)


_NATIVE_CLIP_IO = ()  # unset sentinel (None means "checked, unavailable")


def _native_clip_io():
    """The native codec module, or None if its library cannot load.
    Checked ONCE: retrying a failed cmake build on every read_clip call
    costs a full build attempt per read."""
    global _NATIVE_CLIP_IO
    if _NATIVE_CLIP_IO == ():
        try:
            from realsensetracker_tpu.native import clip_io, load

            load()
            _NATIVE_CLIP_IO = clip_io
        except Exception:
            _NATIVE_CLIP_IO = None
    return _NATIVE_CLIP_IO


def read_clip_py(path: str) -> Clip:
    with open(path, "rb") as f:
        magic = f.read(8)
        if magic not in (MAGIC, MAGIC2):
            raise ValueError(f"{path}: not an RSC clip (magic={magic!r})")
        f_count, h, w, dtype = struct.unpack("<iiii", f.read(16))
        has_color = 0
        if magic == MAGIC2:
            has_color, _reserved = struct.unpack("<ii", f.read(8))
        fx, fy, cx, cy = struct.unpack("<ffff", f.read(16))
        stamps = np.frombuffer(f.read(8 * f_count), dtype="<f8").copy()
        if dtype == DTYPE_U16_MM:
            raw = np.frombuffer(f.read(f_count * h * w * 2), dtype="<u2")
            depths = raw.reshape(f_count, h, w).astype(np.float32) / 1000.0
        elif dtype == DTYPE_F32_M:
            raw = np.frombuffer(f.read(f_count * h * w * 4), dtype="<f4")
            depths = raw.reshape(f_count, h, w).astype(np.float32)
        else:
            raise ValueError(f"unknown clip dtype {dtype}")
        colors = None
        if has_color:
            raw = np.frombuffer(f.read(f_count * h * w * 3), dtype=np.uint8)
            colors = raw.reshape(f_count, h, w, 3).copy()
    intr = camera.Intrinsics(fx=fx, fy=fy, cx=cx, cy=cy, width=w, height=h)
    return Clip(depths=depths, timestamps=stamps, intrinsics=intr, colors=colors)


def record_synthetic_clip(path: str, num_frames: int = 30, seed: int = 0,
                          width: int = 640, height: int = 480,
                          with_color: bool = False) -> Clip:
    """Produce a clip from the raycast scene (dataset-free record path)."""
    from realsensetracker_tpu.data import synthetic

    intr = camera.Intrinsics(
        fx=width * 0.8, fy=width * 0.8, cx=(width - 1) / 2, cy=(height - 1) / 2,
        width=width, height=height,
    )
    stamps = np.arange(num_frames, dtype=np.float64) / 30.0
    if with_color:
        depths, colors, _ = synthetic.render_trajectory_rgbd(intr, num_frames, seed=seed)
        write_clip(path, np.asarray(depths), stamps, intr, colors=np.asarray(colors))
    else:
        depths, _ = synthetic.render_trajectory(intr, num_frames, seed=seed)
        write_clip(path, np.asarray(depths), stamps, intr)
    return read_clip(path)
