"""Public tracking facade: frames in -> poses out.

The stable API the reference exposes through RsViewer/RsDriver + the app
loops; here a single Tracker object selects the backend (projective ICP,
keyframe tracking, frame-to-model, reference-semantics GNC-ICP, or GICP)
and manages the trajectory + optional world model.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from realsensetracker_tpu.api.config import TrackerConfig
from realsensetracker_tpu.geometry import se3
from realsensetracker_tpu.ops import cloud as cloud_mod
from realsensetracker_tpu.ops import voxel as voxel_mod
from realsensetracker_tpu.ops.pyramid import build_pyramid
from realsensetracker_tpu.tracking.frame_to_frame import FrameToFrameTracker
from realsensetracker_tpu.tracking.keyframe import KeyframeTracker
from realsensetracker_tpu.tracking.trajectory import Trajectory


class Tracker:
    """Streaming RGB-D tracker with selectable registration backend."""

    # Integer (raw u16) depth frames are accepted by every method: scaled
    # by config.depth_scale on device (keyframe) or host (_ingest).
    accepts_raw_depth = True

    def __init__(self, config: TrackerConfig | None = None):
        self.config = config or TrackerConfig()
        method = self.config.method
        if method == "projective":
            self._impl = FrameToFrameTracker(
                self.config.intrinsics,
                self.config.projective,
                min_inlier_fraction=self.config.min_inlier_fraction,
                map_capacity=self.config.map_capacity,
                map_voxel_size=self.config.map_voxel_size,
            )
        elif method == "keyframe":
            self._impl = KeyframeTracker(
                self.config.intrinsics,
                self.config.projective,
                min_inlier_fraction=self.config.min_inlier_fraction,
                depth_scale=self.config.depth_scale,
            )
        elif method == "model":
            from realsensetracker_tpu.tracking.frame_to_model import FrameToModelTracker

            kw = {}
            if self.config.map_capacity:
                kw["model_capacity"] = self.config.map_capacity
            self._impl = FrameToModelTracker(
                self.config.intrinsics,
                voxel_size=self.config.map_voxel_size,
                icp_max_iter=self.config.align.icp_max_iter,
                **kw,
            )
        elif method == "tsdf":
            photo_kw = {}
            if self.config.tsdf_photometric:
                photo_kw["photometric"] = self.config.rgbd
            if self.config.tsdf_submap_radius > 0:
                from realsensetracker_tpu.mapping.submaps import (
                    SubmapConfig,
                    SubmapTsdfTracker,
                )

                self._impl = SubmapTsdfTracker(
                    self.config.intrinsics,
                    SubmapConfig(
                        volume=self.config.tsdf,
                        spawn_radius=self.config.tsdf_submap_radius,
                    ),
                    icp=self.config.projective,
                    min_inlier_fraction=self.config.min_inlier_fraction,
                    use_color=self.config.tsdf_color,
                    track_scale_fallback=(
                        self.config.tsdf_track_scale_fallback
                    ),
                    **photo_kw,
                )
            else:
                from realsensetracker_tpu.tracking.tsdf_tracker import TsdfTracker

                self._impl = TsdfTracker(
                    self.config.intrinsics,
                    volume=self.config.tsdf,
                    icp=self.config.projective,
                    min_inlier_fraction=self.config.min_inlier_fraction,
                    use_color=self.config.tsdf_color,
                    depth_scale=self.config.depth_scale,
                    track_scale_fallback=(
                        self.config.tsdf_track_scale_fallback
                    ),
                    **photo_kw,
                )
        elif method == "rgbd":
            from realsensetracker_tpu.tracking.rgbd import RgbdTracker

            self._impl = RgbdTracker(
                self.config.intrinsics,
                self.config.rgbd,
                min_inlier_fraction=self.config.min_inlier_fraction,
            )
        elif method in ("icp", "gicp"):
            self._impl = _CloudTracker(self.config)
        else:
            raise ValueError(f"unknown tracking method: {method}")

    def _ingest(self, depth):
        """Integer (u16) depth frames -> f32 meters on host, for impls
        without a device-side raw path. Impls that declare
        ``accepts_raw_depth`` (KeyframeTracker, plain TsdfTracker) get
        raw uint16 verbatim and convert on device at the scale this
        facade gave them; the others (e.g. the submap atlas, which
        consumes depth on host at handover/reactivation) take meters.
        Probing the impl -- the same protocol the HTTP service uses on
        trackers -- keeps this correct when an impl gains a raw path."""
        if getattr(self._impl, "accepts_raw_depth", False):
            return depth
        from realsensetracker_tpu.data.depth_units import to_meters_np

        a = np.asarray(depth)
        if np.issubdtype(a.dtype, np.integer):
            return to_meters_np(a, self.config.depth_scale)
        return depth

    def process(self, depth, timestamp: float | None = None, color=None):
        """One frame in -> FrameResult-like record out.

        `depth`: (H, W) float meters, or integer raw units scaled by
        config.depth_scale. `color` feeds the photometric term of
        method="rgbd": an (H, W) gray image in [0, 1], or an (H, W, 3)
        image ([0,1] float or uint8) reduced to BT.601 luma. Other
        methods ignore it.
        """
        depth = self._ingest(depth)
        if self.config.method == "rgbd":
            if color is None:
                raise ValueError("method='rgbd' requires a color/gray frame")
            return self._impl.process(depth, _as_gray(color), timestamp)
        if self.config.method == "tsdf" and self.config.tsdf_color:
            # Raw RGB (not luma): the volume fuses per-voxel color.
            return self._impl.process(depth, timestamp, color=color)
        return self._impl.process(depth, timestamp)

    def process_window(self, depths, timestamps=None, window: int = 8,
                       grays=None):
        """Process a batch of frames, scanning up to `window` frames per
        device dispatch (methods 'keyframe' and 'tsdf'; see
        tracking/keyframe.py and tracking/tsdf_tracker.py
        process_window). Identical results to per-frame process(); one
        result per frame. For method='tsdf' with tsdf_color, `grays`
        carries the per-frame RGB color images."""
        if self.config.method == "tsdf":
            return self._impl.process_window(
                [self._ingest(d) for d in depths], timestamps, window=window,
                colors=grays if self.config.tsdf_color else None,
            )
        if self.config.method != "keyframe":
            raise ValueError(
                "process_window() requires method='keyframe' or 'tsdf' "
                f"(got {self.config.method!r})"
            )
        if timestamps is None:
            timestamps = [None] * len(depths)
        results = []
        i = 0
        while i < len(depths):
            # Non-truncating scan: keyframe events promote in-scan, so a
            # window never re-submits its tail (nothing runs between
            # frames at this level -- the SLAM layer, which must act at
            # events, drives the truncating mode itself).
            consumed = self._impl.process_window(
                depths[i : i + window], timestamps[i : i + window],
                pad_to=window, truncate_at_events=False,
            )
            results.extend(consumed)
            i += len(consumed)
        return results

    @property
    def pose(self):
        return self._impl.pose

    @property
    def trajectory(self) -> Trajectory:
        return self._impl.trajectory

    @property
    def world_map(self):
        return getattr(self._impl, "world_map", None)

    def world_mesh(self, capacity: int = 131072):
        """TriangleMesh of the dense model (method='tsdf'), else None."""
        fn = getattr(self._impl, "world_mesh", None)
        return fn(capacity) if fn is not None else None

    @property
    def world_map_colored(self):
        """(Cloud, colors) for color-fusing backends (tsdf_color), else
        None."""
        return getattr(self._impl, "world_map_colored", None)

    @property
    def world_map_oriented(self):
        """(Cloud, normals) for dense backends (method='tsdf'), else
        None."""
        return getattr(self._impl, "world_map_oriented", None)

    def save_trajectory(self, path: str) -> None:
        self.trajectory.save_tum(path)


def _as_gray(color):
    """(H, W) gray | (H, W, 3) RGB -> [0, 1] float32 luma (BT.601).

    uint8 inputs scale by 1/255 in BOTH arities: the photometric term
    (align/rgbd.py) assumes [0, 1] intensities (photo_huber, photo_weight
    are calibrated in those units), so an unscaled 0-255 grayscale would
    silently destroy the geometric/photometric balance.
    """
    arr = np.asarray(color)
    if arr.dtype == np.uint8:
        arr = arr.astype(np.float32) / 255.0
    if arr.ndim == 2:
        return arr.astype(np.float32)
    return arr.astype(np.float32) @ np.asarray([0.299, 0.587, 0.114], np.float32)


@partial(jax.jit, static_argnames=(
    "intr", "voxel_size", "capacity", "method", "icp_max_iter",
    "max_outer", "inner_iters", "cov_k", "use_gicp_cov", "huber_delta"))
def _fused_cloud_step(depth, prev, pose, *, intr, voxel_size, capacity,
                      method, icp_max_iter, max_outer, inner_iters, cov_k,
                      use_gicp_cov, huber_delta):
    """One cloud-tracker frame as a single XLA program (unproject + voxel
    downsample + GNC-ICP/GICP + pose composition + packed stats); see
    tracking/keyframe.py for why each frame is one program. Returns
    (curr_cloud, new_pose_device, relative, stats (18,)) with
    stats = [cost, ok, new_pose(16)]."""
    from realsensetracker_tpu.align import gicp as gicp_mod
    from realsensetracker_tpu.align import icp as icp_mod

    # Cloud backends never read normals/plane tables: skip their
    # construction (CLAUDE.md: source pyramids skip normals).
    levels, _ = build_pyramid(depth, intr, 1, with_normals=False)
    h, w = levels[0].vertex_valid.shape
    c = cloud_mod.Cloud(
        points=levels[0].vertex_map.reshape(h * w, 3),
        mask=levels[0].vertex_valid.reshape(h * w),
    )
    c = voxel_mod.downsample_voxel(c, voxel_size)
    curr = cloud_mod.subsample_to_capacity(c, capacity)

    if method == "icp":
        out = icp_mod.align_icp(curr, prev, icp_max_iter)
        rel, cost = out.transform, out.mean_cost
        ok = jnp.all(jnp.isfinite(rel)) & out.success
    else:
        out = gicp_mod.align_gicp(
            curr, prev, max_outer=max_outer, inner_iters=inner_iters,
            cov_k=cov_k, use_gicp_cov=use_gicp_cov, huber_delta=huber_delta,
        )
        rel, cost = out.transform, out.cost
        # align_gicp's internal NaN guard retains a FINITE identity with
        # cost=inf on degenerate solves -- gate on the cost and on having
        # enough valid points, or an empty frame would be accepted and
        # become the new reference (permanently corrupting tracking).
        ok = (
            jnp.all(jnp.isfinite(rel))
            & jnp.isfinite(cost)
            & (out.num_valid >= 3)
        )
    # accumulate (compose + SE(3) reprojection): raw compose feedback lets
    # f32 rotation denormalization grow without bound over long streams.
    new_pose = se3.accumulate(pose, rel)
    new_pose = jnp.where(ok, new_pose, pose)
    f32 = jnp.float32
    stats = jnp.concatenate([
        jnp.stack([cost.astype(f32), ok.astype(f32)]),
        new_pose.reshape(-1).astype(f32),
    ])
    return curr, new_pose, rel, stats


@partial(jax.jit, static_argnames=("intr", "voxel_size", "capacity"))
def _fused_depth_to_cloud(depth, *, intr, voxel_size, capacity):
    """Depth -> capacity-bounded voxel-downsampled cloud as ONE dispatch
    (instead of one dispatch per eager op on the bootstrap frame). No normals: cloud backends never read them."""
    levels, _ = build_pyramid(depth, intr, 1, with_normals=False)
    h, w = levels[0].vertex_valid.shape
    c = cloud_mod.Cloud(
        points=levels[0].vertex_map.reshape(h * w, 3),
        mask=levels[0].vertex_valid.reshape(h * w),
    )
    c = voxel_mod.downsample_voxel(c, voxel_size)
    return cloud_mod.subsample_to_capacity(c, capacity)


class _CloudTracker:
    """Cloud-based backends: the reference replay-loop semantics
    (rs_replay_app.cpp:244-273) with GNC-ICP or GICP registration on
    voxel-downsampled clouds, one jitted program per frame."""

    def __init__(self, config: TrackerConfig):
        self.config = config
        self._prev = None
        self._pose = None
        self._pose_np = None
        self._index = 0
        self.trajectory = Trajectory()

    @property
    def pose(self):
        return self._pose_np

    def _depth_to_cloud(self, depth):
        cfg = self.config
        return _fused_depth_to_cloud(
            jnp.asarray(depth, jnp.float32),
            intr=cfg.intrinsics,
            voxel_size=float(cfg.align.voxel_size),
            capacity=int(cfg.align.cloud_capacity),
        )

    def process(self, depth, timestamp: float | None = None):
        from realsensetracker_tpu.tracking.frame_to_frame import FrameResult

        if timestamp is None:
            timestamp = float(self._index)
        if self._prev is None:
            self._pose = se3.identity()
            self._pose_np = np.eye(4, dtype=np.float32)
            self._prev = self._depth_to_cloud(depth)
            self.trajectory.append(timestamp, self._pose_np)
            res = FrameResult(
                self._pose_np, se3.identity(), True, 0.0, 1.0, self._index
            )
            self._index += 1
            return res

        g = self.config.gicp
        curr, new_pose_dev, rel, stats = _fused_cloud_step(
            jnp.asarray(depth, jnp.float32), self._prev, self._pose,
            intr=self.config.intrinsics,
            voxel_size=self.config.align.voxel_size,
            capacity=self.config.align.cloud_capacity,
            method=self.config.method,
            icp_max_iter=self.config.align.icp_max_iter,
            max_outer=g.max_outer, inner_iters=g.inner_iters,
            cov_k=g.cov_k, use_gicp_cov=g.use_gicp_cov,
            huber_delta=g.huber_delta,
        )
        s = np.asarray(stats)  # the frame's one host transfer
        cost, ok = float(s[0]), bool(s[1] > 0.5)
        if ok:
            self._pose = new_pose_dev
            self._pose_np = s[2:18].reshape(4, 4)
            self._prev = curr
        self.trajectory.append(timestamp, self._pose_np)
        res = FrameResult(
            self._pose_np, rel, ok, cost, 1.0 if ok else 0.0, self._index
        )
        self._index += 1
        return res
