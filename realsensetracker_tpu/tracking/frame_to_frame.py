"""Frame-to-frame visual odometry driver (BASELINE config 2).

Host-side port of the rs_replay_app main loop (rs_replay_app.cpp:211-298):
per frame, register the current depth frame against the previous one,
compose the result into the global pose, feed the world model, and keep the
old reference frame on failure ("ALIGNMENT FAILED!!", :266-273).

The per-frame compute is ONE jitted program (_fused_f2f_step: pyramid +
projective ICP + SE(3)-projected pose composition + packed scalar stats)
plus, when the world model is on, one jitted map insert: one dispatch and
one small transfer per frame instead of one per eager op and per scalar
read (see tracking/keyframe.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from realsensetracker_tpu.align import projective
from realsensetracker_tpu.geometry import camera, se3
from realsensetracker_tpu.ops.cloud import Cloud
from realsensetracker_tpu.tracking import accumulator as acc_mod
from realsensetracker_tpu.tracking.trajectory import Trajectory


class FrameResult(NamedTuple):
    pose: np.ndarray  # (4, 4) world_from_camera (host array)
    relative: jnp.ndarray  # (4, 4) prev_from_curr
    success: bool
    rmse: float
    inlier_fraction: float
    frame_index: int


@partial(jax.jit, static_argnames=("intr", "cfg"))
def _fused_f2f_step(depth, prev_levels, pose, *, intr, cfg):
    """One tracked frame as a single XLA program; returns
    (levels, new_pose_device, relative_transform, stats (19,)) with
    stats = [rmse, inlier_fraction, finite_ok, new_pose(16)]."""
    from realsensetracker_tpu.ops.pyramid import build_pyramid

    levels, intrs = build_pyramid(
        depth, intr, len(cfg.iters), cfg.min_depth, cfg.max_depth
    )
    icp = projective.projective_icp(levels, prev_levels, tuple(intrs), cfg=cfg)
    new_pose = se3.accumulate(pose, icp.transform)
    ok = jnp.all(jnp.isfinite(icp.transform))
    f32 = jnp.float32
    stats = jnp.concatenate([
        jnp.stack([
            icp.rmse.astype(f32),
            icp.inlier_fraction.astype(f32),
            ok.astype(f32),
        ]),
        new_pose.reshape(-1).astype(f32),
    ])
    return tuple(levels), new_pose, icp.transform, stats


@partial(jax.jit, static_argnames=("count", "voxel_size"))
def _fused_insert(map_state, level0, pose, *, count, voxel_size):
    pts, _, ok = projective.sample_level(level0, count)
    return acc_mod.add_cloud(
        map_state, pose, Cloud(points=pts, mask=ok), voxel_size
    )


@dataclass
class FrameToFrameTracker:
    """Stateful streaming tracker: depth frames in -> world poses out."""

    intr: camera.Intrinsics
    cfg: projective.ProjectiveIcpConfig = projective.ProjectiveIcpConfig()
    min_inlier_fraction: float = 0.2  # tracking-failure gate
    map_capacity: int = 0  # 0 disables the world model
    map_voxel_size: float = 0.05
    map_points_per_frame: int = 4096

    _prev_levels: object = field(default=None, repr=False)
    _pose: object = field(default=None, repr=False)  # device copy
    _pose_np: object = field(default=None, repr=False)  # host mirror
    _map: object = field(default=None, repr=False)
    _index: int = 0
    trajectory: Trajectory = field(default_factory=Trajectory)

    def __post_init__(self):
        # Resolution-aware schedule (see KeyframeTracker.__post_init__).
        self.cfg = projective.fit_levels(
            self.cfg, int(self.intr.height), int(self.intr.width)
        )

    def reset(self) -> None:
        self._prev_levels = None
        self._pose = None
        self._pose_np = None
        self._map = None
        self._index = 0
        self.trajectory = Trajectory()

    @property
    def pose(self):
        return self._pose_np

    @property
    def world_map(self):
        return self._map

    def process(self, depth, timestamp: float | None = None) -> FrameResult:
        from realsensetracker_tpu.ops.pyramid import build_pyramid

        depth = jnp.asarray(depth)
        if timestamp is None:
            timestamp = float(self._index)

        if self._prev_levels is None:
            # Initialization branch (rs_replay_app.cpp:236-240).
            levels, _ = build_pyramid(
                depth, self.intr, len(self.cfg.iters),
                self.cfg.min_depth, self.cfg.max_depth,
            )
            self._pose = se3.identity()
            self._pose_np = np.eye(4, dtype=np.float32)
            self._prev_levels = tuple(levels)
            if self.map_capacity:
                self._map = acc_mod.init_map(self.map_capacity)
                self._map = self._insert(self._prev_levels, self._pose)
            self.trajectory.append(timestamp, self._pose_np)
            res = FrameResult(
                pose=self._pose_np,
                relative=se3.identity(),
                success=True,
                rmse=0.0,
                inlier_fraction=1.0,
                frame_index=self._index,
            )
            self._index += 1
            return res

        # Register curr (src) onto prev (dst): T maps curr -> prev coords.
        levels, new_pose_dev, relative, stats = _fused_f2f_step(
            depth, self._prev_levels, self._pose, intr=self.intr, cfg=self.cfg
        )
        s = np.asarray(stats)  # the frame's one host transfer
        rmse, inlier, finite_ok = float(s[0]), float(s[1]), bool(s[2] > 0.5)
        success = finite_ok and inlier >= self.min_inlier_fraction
        if success:
            # Pose composition (rs_replay_app.cpp:267) + model insert (:268);
            # orthonormalized so per-frame rounding cannot accumulate into
            # R denormalization over long streams.
            self._pose = new_pose_dev
            self._pose_np = s[3:19].reshape(4, 4)
            self._prev_levels = levels
            if self.map_capacity:
                self._map = self._insert(levels, self._pose)
        # On failure: hold pose AND keep the previous reference frame
        # (rs_replay_app.cpp:271-273).
        self.trajectory.append(timestamp, self._pose_np)
        res = FrameResult(
            pose=self._pose_np,
            relative=relative,
            success=success,
            rmse=rmse,
            inlier_fraction=inlier,
            frame_index=self._index,
        )
        self._index += 1
        return res

    def _insert(self, levels, pose):
        return _fused_insert(
            self._map, levels[0], pose,
            count=self.map_points_per_frame, voxel_size=self.map_voxel_size,
        )
