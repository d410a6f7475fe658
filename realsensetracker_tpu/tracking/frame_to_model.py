"""Frame-to-model tracking: register each frame against the world model.

The reference sketches this in a compiled-out branch
(rs_replay_app.cpp:274-287): downsample the current cloud and AlignIcp3d it
against CloudAccumulator::ExtractPointCloud(), then insert. Frame-to-model
drifts less than frame-to-frame because the reference surface is the fused
map, not the previous noisy frame.

Device realization: the device-resident MapAccumulator IS a fixed-capacity
masked cloud, so GNC-ICP runs against it directly (brute-force NN) and
the whole frame -- unproject, voxel downsample, ICP, SE(3)-projected pose,
conditional model insert -- is ONE jitted program per frame (see
tracking/keyframe.py for why each frame is one program).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from realsensetracker_tpu.align import icp as icp_mod
from realsensetracker_tpu.geometry import camera, se3
from realsensetracker_tpu.ops import cloud as cloud_mod
from realsensetracker_tpu.ops import voxel as voxel_mod
from realsensetracker_tpu.tracking import accumulator as acc_mod
from realsensetracker_tpu.tracking.frame_to_frame import FrameResult
from realsensetracker_tpu.tracking.trajectory import Trajectory


def _frame_cloud(depth, intr, voxel_size, frame_capacity) -> cloud_mod.Cloud:
    depth = jnp.asarray(depth, jnp.float32)
    valid = camera.valid_mask(depth, 0.05, 10.0)
    verts = camera.unproject_depth(jnp.where(valid, depth, 0.0), intr)
    h, w = depth.shape
    c = cloud_mod.Cloud(verts.reshape(h * w, 3), valid.reshape(h * w))
    c = voxel_mod.downsample_voxel(c, voxel_size)
    # Spatially uniform capacity reduction (a head slice would crop the
    # high-x region whenever occupied voxels exceed frame_capacity).
    return cloud_mod.subsample_to_capacity(c, frame_capacity)


@partial(jax.jit, static_argnames=(
    "intr", "voxel_size", "frame_capacity", "icp_max_iter", "max_mean_cost"))
def _fused_model_step(depth, model, pose, *, intr, voxel_size,
                      frame_capacity, icp_max_iter, max_mean_cost):
    """One frame-to-model step as a single XLA program.

    Registers the frame cloud onto the world-frame model seeded from the
    previous pose; on success the model absorbs the frame at the new pose
    (tree-select keeps the old model otherwise). Returns
    (new_model, new_pose_device, relative, stats (18,)) with
    stats = [mean_cost, ok, new_pose(16)]."""
    curr = _frame_cloud(depth, intr, voxel_size, frame_capacity)
    out = icp_mod.align_icp(
        curr, model.extract_cloud(), icp_max_iter, init_transform=pose
    )
    # Absolute world_from_camera; orthonormalized because the pose seeds
    # the next frame's registration (feedback loop -- se3.orthonormalize).
    new_pose = se3.orthonormalize(out.transform)
    ok = jnp.all(jnp.isfinite(out.transform)) & (out.mean_cost < max_mean_cost)
    inserted = acc_mod.add_cloud(model, new_pose, curr, voxel_size)
    new_model = jax.tree.map(
        lambda a, b: jnp.where(ok, a, b), inserted, model
    )
    new_pose = jnp.where(ok, new_pose, pose)
    f32 = jnp.float32
    stats = jnp.concatenate([
        jnp.stack([out.mean_cost.astype(f32), ok.astype(f32)]),
        new_pose.reshape(-1).astype(f32),
    ])
    # FrameResult.relative is documented as prev_from_curr (the inter-frame
    # motion); align_icp's output here is the ABSOLUTE world_from_camera.
    relative = se3.compose(se3.inverse(pose), new_pose)
    return new_model, new_pose, relative, stats


@dataclass
class FrameToModelTracker:
    """Streaming tracker registering every frame against the fused map."""

    intr: camera.Intrinsics
    voxel_size: float = 0.05  # rs_replay_app.cpp:279
    icp_max_iter: int = 64
    frame_capacity: int = 4096
    model_capacity: int = 32768
    max_mean_cost: float = 0.25  # tracking-failure gate (meters RMS)

    _pose: object = field(default=None, repr=False)  # device copy
    _pose_np: object = field(default=None, repr=False)  # host mirror
    _model: object = field(default=None, repr=False)
    _index: int = 0
    trajectory: Trajectory = field(default_factory=Trajectory)

    @property
    def pose(self):
        return self._pose_np

    @property
    def world_map(self):
        return self._model

    def process(self, depth, timestamp: float | None = None) -> FrameResult:
        if timestamp is None:
            timestamp = float(self._index)

        if self._model is None:
            curr = _frame_cloud(
                depth, self.intr, self.voxel_size, self.frame_capacity
            )
            self._pose = se3.identity()
            self._pose_np = np.eye(4, dtype=np.float32)
            self._model = acc_mod.init_map(self.model_capacity)
            self._model = acc_mod.add_cloud(
                self._model, self._pose, curr, self.voxel_size
            )
            self.trajectory.append(timestamp, self._pose_np)
            res = FrameResult(
                self._pose_np, se3.identity(), True, 0.0, 1.0, self._index
            )
            self._index += 1
            return res

        new_model, new_pose_dev, relative, stats = _fused_model_step(
            jnp.asarray(depth, jnp.float32), self._model, self._pose,
            intr=self.intr, voxel_size=self.voxel_size,
            frame_capacity=self.frame_capacity,
            icp_max_iter=self.icp_max_iter,
            max_mean_cost=self.max_mean_cost,
        )
        s = np.asarray(stats)  # the frame's one host transfer
        cost, ok = float(s[0]), bool(s[1] > 0.5)
        self._model = new_model
        self._pose = new_pose_dev
        if ok:
            self._pose_np = s[2:18].reshape(4, 4)
        self.trajectory.append(timestamp, self._pose_np)
        res = FrameResult(
            pose=self._pose_np,
            relative=relative,
            success=ok,
            rmse=cost,
            inlier_fraction=1.0 if ok else 0.0,
            frame_index=self._index,
        )
        self._index += 1
        return res
