"""TUM RGB-D dataset loader (fr1/desk is the BASELINE parity dataset).

Replaces the reference's camera/protobuf ingestion (rs_driver.cpp,
rs_replay_app.cpp:219-225) for offline evaluation. TUM format: per-sequence
directory with depth/ (16-bit PNG, meters = value / 5000), rgb/, and
timestamped index files depth.txt / rgb.txt / groundtruth.txt.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

DEPTH_SCALE = 5000.0  # TUM convention: png_value / 5000 = meters


def _read_index(path: str) -> list[tuple[float, str]]:
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            out.append((float(parts[0]), parts[1]))
    return out


def _read_groundtruth(path: str) -> list[tuple[float, np.ndarray]]:
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            v = [float(x) for x in line.split()]
            out.append((v[0], np.asarray(v[1:8])))  # tx ty tz qx qy qz qw
    return out


@dataclass
class TumSequence:
    """Lazy TUM sequence: depth frames decoded on demand."""

    root: str
    depth_index: list
    rgb_index: list
    groundtruth: list

    @staticmethod
    def open(root: str) -> "TumSequence":
        depth = _read_index(os.path.join(root, "depth.txt"))
        rgb_path = os.path.join(root, "rgb.txt")
        rgb = _read_index(rgb_path) if os.path.exists(rgb_path) else []
        gt_path = os.path.join(root, "groundtruth.txt")
        gt = _read_groundtruth(gt_path) if os.path.exists(gt_path) else []
        return TumSequence(root=root, depth_index=depth, rgb_index=rgb, groundtruth=gt)

    def __len__(self) -> int:
        return len(self.depth_index)

    def timestamp(self, i: int) -> float:
        return self.depth_index[i][0]

    def depth(self, i: int) -> np.ndarray:
        """Depth frame i as float32 meters (0 = invalid)."""
        ts, rel = self.depth_index[i]
        del ts
        return load_depth_png(os.path.join(self.root, rel))

    def depth_raw(self, i: int) -> np.ndarray:
        """Depth frame i as RAW uint16 (meters = value / DEPTH_SCALE).

        Raw frames feed trackers with depth_scale=1/DEPTH_SCALE at HALF
        the host->device upload bytes of f32 -- the upload rides the
        timed dispatch on windowed paths."""
        ts, rel = self.depth_index[i]
        del ts
        return load_depth_png_raw(os.path.join(self.root, rel))

    def rgb(self, i: int) -> np.ndarray:
        """RGB frame i (by rgb.txt index) as (H, W, 3) uint8."""
        ts, rel = self.rgb_index[i]
        del ts
        return load_rgb_png(os.path.join(self.root, rel))

    def rgb_for_depth(self, i: int, max_dt: float = 0.05) -> np.ndarray | None:
        """RGB frame time-associated with depth frame i (TUM association
        rule: nearest rgb timestamp within max_dt), or None."""
        j = self.associate_rgb(i, max_dt)
        return None if j is None else self.rgb(j)

    def associate_rgb(self, i: int, max_dt: float = 0.05) -> int | None:
        """Index into rgb_index nearest in time to depth frame i, or None."""
        if not self.rgb_index:
            return None
        ts = self.depth_index[i][0]
        import bisect

        # Cache the stamp list: rebuilding it per call made frames_rgbd
        # O(frames x rgb_entries) on the host ingest path.
        stamps = getattr(self, "_rgb_stamps", None)
        if stamps is None or len(stamps) != len(self.rgb_index):
            stamps = [t for t, _ in self.rgb_index]
            object.__setattr__(self, "_rgb_stamps", stamps)
        j = bisect.bisect_left(stamps, ts)
        best, best_dt = None, max_dt
        for k in (j - 1, j):
            if 0 <= k < len(stamps) and abs(stamps[k] - ts) <= best_dt:
                best, best_dt = k, abs(stamps[k] - ts)
        return best

    def load_depth_batch(self, indices, raw: bool = False) -> np.ndarray:
        """Decode many depth frames at once -> (N, H, W) float32 meters,
        or raw uint16 counts with ``raw=True`` (feeds trackers at half
        the upload bytes -- see depth_raw).

        Uses the native thread-pooled batch decoder
        (native/src/png16.cpp png16_decode_batch) so ingest scales across
        host cores; falls back to per-frame decoding without the library.
        """
        indices = list(indices)
        if not indices:
            return np.zeros((0, 0, 0), np.uint16 if raw else np.float32)
        try:
            import ctypes

            from realsensetracker_tpu.native import load, png_io

            paths = [
                os.path.join(self.root, self.depth_index[i][1]) for i in indices
            ]
            dims = np.zeros(4, np.int32)
            rc = load().png16_read_header(
                paths[0].encode(), dims.ctypes.data_as(ctypes.c_void_p)
            )
            if rc != 0:
                raise ValueError(paths[0])
            w, h = int(dims[0]), int(dims[1])
            return png_io.read_png16_batch(
                paths, h, w, scale=None if raw else DEPTH_SCALE
            )
        except Exception:
            get = self.depth_raw if raw else self.depth
            return np.stack([get(i) for i in indices])

    def frames(self, start: int = 0, stop: int | None = None,
               batch_decode: int = 8, raw: bool = False):
        """Yield (timestamp, depth) decoding `batch_decode` frames ahead
        through the native thread pool (1 disables batching). ``raw=True``
        yields uint16 counts instead of f32 meters (see depth_raw)."""
        stop = len(self) if stop is None else min(stop, len(self))
        if batch_decode <= 1:
            get = self.depth_raw if raw else self.depth
            for i in range(start, stop):
                yield self.timestamp(i), get(i)
            return
        for b in range(start, stop, batch_decode):
            idx = range(b, min(b + batch_decode, stop))
            block = self.load_depth_batch(idx, raw=raw)
            for off, i in enumerate(idx):
                yield self.timestamp(i), block[off]

    def frames_rgbd(self, start: int = 0, stop: int | None = None,
                    batch_decode: int = 8):
        """Yield (timestamp, depth, gray | None): gray is the associated RGB
        frame's [0,1] float32 luma (the photometric term's input). Depth
        decodes `batch_decode` frames ahead through the native thread pool,
        same as frames() (RGB stays per-frame: PIL owns that format)."""
        stop = len(self) if stop is None else min(stop, len(self))
        for b in range(start, stop, max(batch_decode, 1)):
            idx = range(b, min(b + max(batch_decode, 1), stop))
            block = (self.load_depth_batch(idx) if batch_decode > 1
                     else None)
            for off, i in enumerate(idx):
                rgb = self.rgb_for_depth(i)
                gray = None if rgb is None else rgb_to_gray(rgb)
                depth = block[off] if block is not None else self.depth(i)
                yield self.timestamp(i), depth, gray

    def groundtruth_trajectory(self):
        from realsensetracker_tpu.tracking.trajectory import Trajectory
        from realsensetracker_tpu.geometry import se3
        import jax.numpy as jnp

        traj = Trajectory()
        for ts, v in self.groundtruth:
            T = np.eye(4)
            T[:3, :3] = np.asarray(
                se3.matrix_from_quaternion(jnp.asarray(v[3:7], jnp.float32))
            )
            T[:3, 3] = v[:3]
            traj.append(ts, T)
        return traj


def load_depth_png_raw(path: str) -> np.ndarray:
    """16-bit depth PNG -> raw uint16 counts. Uses the native C++ decoder
    when built (realsensetracker_tpu.native), else PIL."""
    try:
        from realsensetracker_tpu.native import png_io

        return png_io.read_png16(path)
    except Exception:
        from PIL import Image

        return np.asarray(Image.open(path), dtype=np.uint16)


def load_depth_png(path: str) -> np.ndarray:
    """16-bit depth PNG -> float32 meters."""
    return load_depth_png_raw(path).astype(np.float32) / DEPTH_SCALE


def load_rgb_png(path: str) -> np.ndarray:
    """8-bit RGB PNG -> (H, W, 3) uint8 (TUM rgb/ frames)."""
    from PIL import Image

    img = Image.open(path)
    if img.mode != "RGB":
        img = img.convert("RGB")
    return np.asarray(img, dtype=np.uint8)


def rgb_to_gray(rgb: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 -> float32 [0,1] BT.601 luma."""
    return (rgb.astype(np.float32) / 255.0) @ np.asarray(
        [0.299, 0.587, 0.114], np.float32
    )


def synthesize_tum_sequence(root: str, num_frames: int = 10, seed: int = 0,
                            width: int = 640, height: int = 480,
                            with_color: bool = False, poses=None,
                            scene=None) -> str:
    """Write a small synthetic TUM-format sequence (tests / offline demos).

    Renders the raycast scene along a random-walk trajectory and saves
    16-bit depth PNGs + depth.txt + groundtruth.txt; with_color also writes
    8-bit rgb/ frames + rgb.txt (the reference's color stream analog).
    `scene` overrides the default raycast scene (e.g. a geometry-degenerate
    textured wall for RGB-D odometry demos).
    """
    import jax.numpy as jnp
    from PIL import Image

    from realsensetracker_tpu.data import synthetic
    from realsensetracker_tpu.geometry import camera, se3

    intr = camera.Intrinsics(
        fx=width * 0.8, fy=width * 0.8, cx=(width - 1) / 2, cy=(height - 1) / 2,
        width=width, height=height,
    )
    if poses is not None:
        poses = jnp.asarray(poses, jnp.float32)
    if with_color:
        depths, colors, poses = synthetic.render_trajectory_rgbd(
            intr, num_frames, scene=scene, seed=seed, poses=poses
        )
        os.makedirs(os.path.join(root, "rgb"), exist_ok=True)
    else:
        depths, poses = synthetic.render_trajectory(
            intr, num_frames, scene=scene, seed=seed, poses=poses
        )
        colors = None
    os.makedirs(os.path.join(root, "depth"), exist_ok=True)
    index_lines, rgb_lines, gt_lines = [], [], []
    for i in range(num_frames):
        ts = i / 30.0
        # Round, don't truncate: truncation biases every synthesized depth
        # by -0.1 mm on average (write_clip rounds too).
        d16 = np.clip(np.round(np.asarray(depths[i]) * DEPTH_SCALE),
                      0, 65535).astype(np.uint16)
        rel = f"depth/{ts:.6f}.png"
        Image.fromarray(d16).save(os.path.join(root, rel))
        index_lines.append(f"{ts:.6f} {rel}")
        if colors is not None:
            c8 = np.clip(np.round(np.asarray(colors[i]) * 255.0),
                         0, 255).astype(np.uint8)
            rel_rgb = f"rgb/{ts:.6f}.png"
            Image.fromarray(c8).save(os.path.join(root, rel_rgb))
            rgb_lines.append(f"{ts:.6f} {rel_rgb}")
        T = np.asarray(poses[i])
        q = np.asarray(se3.quaternion_from_matrix(jnp.asarray(T[:3, :3])))
        t = T[:3, 3]
        gt_lines.append(
            f"{ts:.6f} {t[0]:.6f} {t[1]:.6f} {t[2]:.6f} "
            f"{q[0]:.6f} {q[1]:.6f} {q[2]:.6f} {q[3]:.6f}"
        )
    with open(os.path.join(root, "depth.txt"), "w") as f:
        f.write("\n".join(index_lines) + "\n")
    if rgb_lines:
        with open(os.path.join(root, "rgb.txt"), "w") as f:
            f.write("\n".join(rgb_lines) + "\n")
    with open(os.path.join(root, "groundtruth.txt"), "w") as f:
        f.write("\n".join(gt_lines) + "\n")
    return root
