"""Frame-to-frame RGB-D visual odometry (joint geometry + photometry).

The colored counterpart of tracking/frame_to_frame.py: per frame, register
the current depth+intensity pair against the previous one with the combined
point-to-plane + photometric objective (align/rgbd.py), compose into the
global pose, and hold the reference frame on failure -- the reference's
replay-loop semantics (rs_replay_app.cpp:211-298) with the color stream
(rs_driver.cpp:33-103) finally consumed by the tracker instead of only the
viewer.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from realsensetracker_tpu.align import rgbd as rgbd_mod
from realsensetracker_tpu.geometry import camera, se3
from realsensetracker_tpu.tracking.frame_to_frame import FrameResult
from realsensetracker_tpu.tracking.trajectory import Trajectory


@partial(jax.jit, static_argnames=("intr", "cfg"))
def _fused_rgbd_step(depth, gray, prev_levels, prev_grays, pose, *, intr, cfg):
    """One RGB-D tracked frame as a single XLA program (see
    tracking/keyframe.py for why each frame is one program).

    Returns (target_levels, target_grays, new_pose_device, relative,
    stats (19,)) with stats = [rmse, inlier_fraction, finite_ok,
    new_pose(16)]. Per-level intrinsics are recomputed statically from
    `intr` so the previous target carries only device arrays."""
    levels, grays, intrs = rgbd_mod.build_rgbd_target(depth, gray, intr, cfg)
    src_samples = rgbd_mod.sample_rgbd_source(depth, gray, intrs, cfg)
    out = rgbd_mod.rgbd_icp_sampled(
        src_samples, prev_levels, prev_grays, intrs, cfg=cfg
    )
    new_pose = se3.accumulate(pose, out.transform)
    ok = jnp.all(jnp.isfinite(out.transform))
    f32 = jnp.float32
    stats = jnp.concatenate([
        jnp.stack([
            out.rmse.astype(f32),
            out.inlier_fraction.astype(f32),
            ok.astype(f32),
        ]),
        new_pose.reshape(-1).astype(f32),
    ])
    return levels, grays, new_pose, out.transform, stats


@dataclass
class RgbdTracker:
    """Stateful streaming tracker: (depth, gray) frames in -> poses out."""

    intr: camera.Intrinsics
    cfg: rgbd_mod.RgbdIcpConfig = rgbd_mod.RgbdIcpConfig()
    min_inlier_fraction: float = 0.2

    _prev_target: object = field(default=None, repr=False)  # (levels, grays)
    _pose: object = field(default=None, repr=False)  # device copy
    _pose_np: object = field(default=None, repr=False)  # host mirror
    _index: int = 0
    trajectory: Trajectory = field(default_factory=Trajectory)

    def __post_init__(self):
        # Resolution-aware schedule (see KeyframeTracker.__post_init__):
        # build_rgbd_target fits internally, so WITHOUT this the stored
        # cfg would disagree with the built level count at sub-VGA
        # resolutions and rgbd_icp_sampled's level-count assert fires.
        from realsensetracker_tpu.align import projective

        self.cfg = projective.fit_levels(
            self.cfg, int(self.intr.height), int(self.intr.width)
        )

    def reset(self) -> None:
        self._prev_target = None
        self._pose = None
        self._pose_np = None
        self._index = 0
        self.trajectory = Trajectory()

    @property
    def pose(self):
        return self._pose_np

    def process(self, depth, gray, timestamp: float | None = None) -> FrameResult:
        depth = jnp.asarray(depth, jnp.float32)
        gray = jnp.asarray(gray, jnp.float32)
        if timestamp is None:
            timestamp = float(self._index)

        if self._prev_target is None:
            # Destination-side preproc is kept for the NEXT frame (each
            # frame is preprocessed exactly once, as dst; src-side is
            # sampled on the fly).
            levels, grays, _ = rgbd_mod.build_rgbd_target(
                depth, gray, self.intr, self.cfg
            )
            self._pose = se3.identity()
            self._pose_np = np.eye(4, dtype=np.float32)
            self._prev_target = (levels, grays)
            self.trajectory.append(timestamp, self._pose_np)
            res = FrameResult(
                self._pose_np, se3.identity(), True, 0.0, 1.0, self._index
            )
            self._index += 1
            return res

        dst_levels, dst_grays = self._prev_target
        levels, grays, new_pose_dev, relative, stats = _fused_rgbd_step(
            depth, gray, dst_levels, dst_grays, self._pose,
            intr=self.intr, cfg=self.cfg,
        )
        s = np.asarray(stats)  # the frame's one host transfer
        rmse, inlier, finite_ok = float(s[0]), float(s[1]), bool(s[2] > 0.5)
        success = finite_ok and inlier >= self.min_inlier_fraction
        if success:
            self._pose = new_pose_dev
            self._pose_np = s[3:19].reshape(4, 4)
            self._prev_target = (levels, grays)
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
