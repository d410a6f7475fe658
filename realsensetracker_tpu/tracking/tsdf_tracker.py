"""TSDF frame-to-model tracking: register every frame against a raycast
render of the fused dense volume (KinectFusion tracking loop).

The reference's compiled-out frame-to-model branch
(rs_replay_app.cpp:274-287) registers the frame cloud against the sparse
accumulated point map; tracking/frame_to_model.py realizes that design.
This tracker is the dense upgrade: the model is a TSDF volume
(mapping/tsdf.py), and the reference surface for registration is a
SYNTHETIC depth frame raycast from the volume at the previous pose. The
render averages away per-frame sensor noise, so the pose feedback loop
tracks against a cleaner, globally-fused surface -- the property that
made KinectFusion drift-free enough to scan rooms.

Device shape: one frame = ONE jitted program (raycast -> projective
point-to-plane GN -> gated volume integration), with the volume and pose
living on device across the whole sequence; the host sees only a packed
(19,) stats row per frame.
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
from realsensetracker_tpu.mapping import tsdf as tsdf_mod
from realsensetracker_tpu.ops.pyramid import depth_to_meters, downsample_depth
from realsensetracker_tpu.tracking.frame_to_frame import FrameResult
from realsensetracker_tpu.tracking.trajectory import Trajectory


def _track_views(depth, intr, track_scale):
    """(tracking-resolution depth, intrinsics) for a live frame.

    ``track_scale`` (TsdfConfig.track_scale, power of two) halves the
    frame that many times with the ICP pyramid's validity-aware 2x2
    pooling (invalid pixels stay 0, the registration stack's missing-
    depth convention) and scales the intrinsics with the SAME odd-
    dimension rule (Intrinsics.halved matches downsample_depth's
    floor-halving). The solved transform is metric, so registering at
    reduced resolution changes nothing downstream -- it only cuts the
    model-render raycast and GN gather bills ~track_scale^2-fold."""
    if track_scale <= 1:
        return depth, intr
    if track_scale & (track_scale - 1):
        raise ValueError(f"track_scale={track_scale} must be a power of 2")
    valid = jnp.isfinite(depth) & (depth > 0)
    s = track_scale
    while s > 1:
        depth, valid = downsample_depth(depth, valid)
        intr = intr.halved()
        s //= 2
    return jnp.where(valid, depth, 0.0), intr


def _pool_gray(gray, track_scale):
    """Plain 2x2 mean pooling of an intensity image to the tracking
    resolution (intensity has no invalid sentinel; the RGB-D aligner
    gates by DEPTH validity internally)."""
    s = track_scale
    while s > 1:
        h = gray.shape[-2] // 2 * 2
        w = gray.shape[-1] // 2 * 2
        gray = gray[..., :h, :w].reshape(
            *gray.shape[:-2], h // 2, 2, w // 2, 2
        ).mean(axis=(-3, -1))
        s //= 2
    return gray


TSDF_STATS_WIDTH = 21  # [rmse, inlier_fraction, ok, pose(16),
# track_cov, fused] -- see TsdfStepOut.stats


class TsdfStepOut(NamedTuple):
    """Result of one frame-to-model step. Keyword-stable on purpose:
    every call site (the per-frame jit, the windowed scan body, and the
    vmapped multi-stream demo in parallel/streams.py) unpacks by
    attribute, so adding a field cannot silently desync a caller that
    positionally unpacked an old arity."""

    vol: object  # updated TSDF volume
    pose: jnp.ndarray  # (4,4) new world_from_cam
    relative: jnp.ndarray  # (4,4) accepted relative transform (I on fail)
    gray: object  # next photometric reference (None when photo off)
    stats: jnp.ndarray  # (TSDF_STATS_WIDTH,) [rmse, inlier_fraction, ok,
    # pose(16), track_cov, fused]. track_cov = valid model-render pixels
    # / valid live-frame pixels at the TRACKING resolution -- the
    # constraint-coverage diagnostic behind the track_scale auto-
    # fallback (structures thinner than the reduced pixel footprint
    # vanish from the render, so coverage collapses while the solve
    # still "succeeds"). fused = 1.0 when this frame integrated
    # (integrate_every cadence AND registration ok).


def _tsdf_step_math(vol, depth, pose, color, valid, prev_gray=None, *,
                    intr, vol_cfg, icp_cfg, min_inlier_fraction,
                    photo_cfg=None, photo_ref="frame", fuse=None):
    """One frame-to-model step (traced body, shared by the per-frame jit
    and the windowed lax.scan).

    Raycasts the model at the previous pose, registers the incoming
    frame onto the render (the render plays the `dst`/reference role, so
    the solved transform is render_cam_from_curr_cam -- composing right
    onto the previous world_from_cam pose), then integrates the frame at
    the new pose. Tracking failure (non-finite transform or inlier
    fraction below the gate) holds BOTH the pose and the volume -- a
    misregistered frame must not corrupt the map it will be tracked
    against next (reference failure-holds-pose semantics,
    rs_replay_app.cpp:257-267, extended to the model). ``valid`` False
    (window tail padding) behaves exactly like a failed frame: state
    holds, stats row is discarded by the host.

    With ``photo_cfg`` (an RgbdIcpConfig; requires a colored volume and
    per-frame color), registration is JOINT geometric + photometric --
    photometric KinectFusion: the photo term pins the in-plane motion
    that point-to-plane cannot observe on geometry-degenerate scenes.
    The GEOMETRIC reference is always the model render (denoised, fused
    surface); the PHOTOMETRIC reference is chosen by ``photo_ref``:
    "frame" (default) uses the PREVIOUS raw gray -- legal because the
    previous frame and the model render live in the SAME (previous)
    camera frame -- and is ~100x more accurate than "model", whose
    trilinear fused-color render carries voxel-scale intensity error
    (measured 56 mm vs 0.9 mm drift on a 0.2 m wall slide).

    ``fuse`` (traced bool; required iff vol_cfg.integrate_every > 1)
    gates the integration pass on the decimation cadence: a successful
    frame with fuse False updates the pose but not the volume.

    Returns a TsdfStepOut; stats = [rmse, inlier_fraction, ok,
    new_pose(16), track_cov, fused]; gray is the photometric reference
    for the NEXT step (None when photo_cfg is None), holding on failure
    exactly like the pose.
    """
    new_gray = None
    # Registration runs at the TRACKING resolution (TsdfConfig.track_scale;
    # 1 = full). The model renders directly at the reduced intrinsics (the
    # raycast is the step's dominant gather bill), the live frame pools
    # down validity-aware, and the full-resolution frame still integrates
    # below -- map quality is unaffected by the tracking resolution.
    track_scale = int(getattr(vol_cfg, "track_scale", 1))
    t_depth, t_intr = _track_views(depth, intr, track_scale)
    if photo_cfg is not None:
        from realsensetracker_tpu.align import rgbd as rgbd_mod

        luma = jnp.asarray([0.299, 0.587, 0.114], jnp.float32)
        gray = jnp.sum(color * luma, axis=-1)
        if photo_ref == "frame":
            model_depth = tsdf_mod.render_model_depth(vol, pose, t_intr,
                                                      vol_cfg)
            ref_gray = _pool_gray(prev_gray, track_scale)
        else:
            model_depth, ref_gray = tsdf_mod.render_model_rgbd(
                vol, pose, t_intr, vol_cfg
            )
        res = rgbd_mod.register_rgbd_pair(
            t_depth, _pool_gray(gray, track_scale), model_depth, ref_gray,
            t_intr, photo_cfg
        )
    else:
        model_depth = tsdf_mod.render_model_depth(vol, pose, t_intr,
                                                  vol_cfg)
        res = projective.register_depth_pair(t_depth, model_depth, t_intr,
                                             icp_cfg)
    ok = (
        jnp.all(jnp.isfinite(res.transform))
        & (res.inlier_fraction >= min_inlier_fraction)
        & valid
    )
    # Constraint coverage at the tracking resolution: the fraction of
    # valid live pixels the model render can constrain. This is the
    # signal track-scale reduction silently erodes on thin structures.
    f32 = jnp.float32
    track_cov = jnp.sum((model_depth > 0).astype(f32)) / jnp.maximum(
        jnp.sum((t_depth > 0).astype(f32)), 1.0
    )
    n_every = int(getattr(vol_cfg, "integrate_every", 1))
    do_int = (ok & fuse) if n_every > 1 else ok
    new_pose = se3.orthonormalize(se3.compose(pose, res.transform))
    new_pose = jnp.where(ok, new_pose, pose)
    # cond, not select: on failure (or a decimated-out frame) the
    # integration pass (the volume's full traversal) is skipped
    # entirely, not computed-and-discarded.
    new_vol = jax.lax.cond(
        do_int,
        lambda v: tsdf_mod.integrate(
            v, depth, new_pose, intr, vol_cfg, color=color
        ),
        lambda v: v,
        vol,
    )
    stats = jnp.concatenate([
        jnp.stack([
            res.rmse.astype(f32),
            res.inlier_fraction.astype(f32),
            ok.astype(f32),
        ]),
        new_pose.reshape(-1).astype(f32),
        jnp.stack([track_cov.astype(f32), do_int.astype(f32)]),
    ])
    relative = jnp.where(ok, res.transform, jnp.eye(4, dtype=f32))
    if photo_cfg is not None:
        # The reference gray follows the same hold-on-failure contract
        # as the pose: a failed frame's image must not become the next
        # frame's photometric anchor at the held pose.
        new_gray = jnp.where(ok, gray, prev_gray) if photo_ref == "frame" \
            else gray
    return TsdfStepOut(new_vol, new_pose, relative, new_gray, stats)


@partial(jax.jit, static_argnames=(
    "intr", "vol_cfg", "icp_cfg", "min_inlier_fraction", "photo_cfg",
    "photo_ref", "depth_scale"))
def _fused_tsdf_step(vol, depth, pose, color=None, prev_gray=None,
                     fuse=None, *, intr, vol_cfg, icp_cfg,
                     min_inlier_fraction, photo_cfg=None,
                     photo_ref="frame", depth_scale=1.0):
    """One frame-to-model step as a single XLA program (see
    _tsdf_step_math)."""
    return _tsdf_step_math(
        vol, depth_to_meters(depth, depth_scale), pose, color,
        jnp.bool_(True), prev_gray, intr=intr,
        vol_cfg=vol_cfg, icp_cfg=icp_cfg,
        min_inlier_fraction=min_inlier_fraction, photo_cfg=photo_cfg,
        photo_ref=photo_ref, fuse=fuse,
    )


@partial(jax.jit, static_argnames=(
    "intr", "vol_cfg", "icp_cfg", "min_inlier_fraction", "with_color",
    "photo_cfg", "photo_ref", "depth_scale"))
def _fused_tsdf_window(vol, depths, pose, valids, colors=None,
                       prev_gray=None, fuses=None, *, intr, vol_cfg,
                       icp_cfg, min_inlier_fraction, with_color,
                       photo_cfg=None, photo_ref="frame",
                       depth_scale=1.0):
    """W frame-to-model steps as ONE lax.scan dispatch.

    The volume and pose ride the scan carry (they never leave the
    device mid-window), so a window costs one dispatch instead of
    W -- the same amortization the windowed SLAM/keyframe paths use
    (tracking/keyframe.py process_window). Per-frame results are
    IDENTICAL to W process() calls: the body is the same traced step
    math, and padded tail frames (valids False) hold state exactly like
    failed frames. ``fuses`` is the (W,) integrate_every cadence (None
    when decimation is off). Returns (vol, pose, relatives (W,4,4),
    gray, stats (W, TSDF_STATS_WIDTH)).
    """
    def body(carry, x):
        vol, pose, pg = carry
        if with_color:
            depth, color, valid, fuse = x
        else:
            (depth, valid, fuse), color = x, None
        out = _tsdf_step_math(
            vol, depth, pose, color, valid, pg, intr=intr,
            vol_cfg=vol_cfg, icp_cfg=icp_cfg,
            min_inlier_fraction=min_inlier_fraction, photo_cfg=photo_cfg,
            photo_ref=photo_ref, fuse=fuse,
        )
        return (out.vol, out.pose, out.gray), (out.relative, out.stats)

    depths = depth_to_meters(depths, depth_scale)
    xs = (
        (depths, colors, valids, fuses) if with_color
        else (depths, valids, fuses)
    )
    (vol, pose, prev_gray), (rels, stats) = jax.lax.scan(
        body, (vol, pose, prev_gray), xs
    )
    return vol, pose, rels, prev_gray, stats


@partial(jax.jit, static_argnames=("intr", "vol_cfg", "with_color",
                                   "depth_scale"))
def _seed_volume(depth, intr, vol_cfg, color=None, with_color=False,
                 depth_scale=1.0):
    depth = depth_to_meters(depth, depth_scale)
    vol = tsdf_mod.init_volume(vol_cfg, with_color=with_color)
    return tsdf_mod.integrate(
        vol, depth, se3.identity(), intr, vol_cfg, color=color
    )


@dataclass
class TsdfTracker:
    """Streaming dense frame-to-model tracker (KinectFusion loop)."""

    # Raw integer (u16) frames convert to meters ON DEVICE at
    # self.depth_scale (the probe protocol of api/service.py
    # _ingest_depth / api/tracker.Tracker._ingest).
    accepts_raw_depth = True

    intr: camera.Intrinsics
    volume: tsdf_mod.TsdfConfig = tsdf_mod.TsdfConfig()
    icp: projective.ProjectiveIcpConfig = projective.ProjectiveIcpConfig()
    min_inlier_fraction: float = 0.2
    surface_capacity: int = 65536  # extract_surface output size
    use_color: bool = False  # fuse per-voxel RGB (registration stays
    # geometric); process() then requires a color frame per call
    photometric: object = None  # RgbdIcpConfig | None: joint geometric +
    # photometric frame-to-model registration (photometric
    # KinectFusion); requires use_color
    photometric_ref: str = "frame"  # "frame": photo reference = previous
    # raw gray (same camera frame as the model render; ~100x more
    # accurate); "model": photo reference = trilinear fused-color render
    depth_scale: float = 1e-3  # meters per raw unit for INTEGER depth
    # frames: raw uint16 uploads at half the f32 bytes and converts on
    # device inside the fused programs (ops/pyramid.depth_to_meters)
    track_scale_fallback: float = 0.0  # constraint-coverage floor for
    # reduced-resolution tracking (TsdfConfig.track_scale > 1): when the
    # per-frame track_cov diagnostic (valid render px / valid frame px
    # at the tracking resolution) stays below this for
    # fallback_patience consecutive frames, the tracker PERMANENTLY
    # (until the next reseed) switches registration back to full
    # resolution -- the safety net for scenes whose structures are
    # thinner than the reduced pixel footprint (they vanish from the
    # reduced render while the solve still reports success). 0 = off.
    # One extra compiled program on the first fallback. The windowed
    # path applies the switch at the next chunk boundary.
    fallback_patience: int = 3

    _vol: object = field(default=None, repr=False)
    _prev_gray: object = field(default=None, repr=False)  # photo ref
    _pose: object = field(default=None, repr=False)  # device copy
    _pose_np: object = field(default=None, repr=False)  # host mirror
    _index: int = 0
    # integrate_every cadence counter: frames since the (re)seed (the
    # seed itself is fuse slot 0). Host-side -- the due flag is data.
    _fuse_counter: int = 0
    # track_scale fallback state: the ACTIVE tracking config (may have
    # track_scale forced to 1 after a fallback) + low-coverage streak.
    _track_cfg: object = field(default=None, repr=False)
    _low_cov_streak: int = 0
    num_track_scale_fallbacks: int = 0
    trajectory: Trajectory = field(default_factory=Trajectory)

    def __post_init__(self):
        if self.photometric is not None and not self.use_color:
            raise ValueError(
                "photometric frame-to-model needs use_color=True (color "
                "drives the photometric term and the colored model)"
            )
        if self.photometric_ref not in ("frame", "model"):
            raise ValueError("photometric_ref must be 'frame' or 'model'")
        self._track_cfg = self.volume

    @property
    def track_scale_active(self) -> int:
        """The tracking-resolution divisor currently in effect (drops to
        1 after a track_scale_fallback trigger)."""
        return int(getattr(self._track_cfg, "track_scale", 1))

    def _fuse_due(self) -> object:
        """Traced integrate_every due flag for the next frame (None when
        decimation is off)."""
        n = int(getattr(self.volume, "integrate_every", 1))
        if n <= 1:
            return None
        return jnp.bool_(self._fuse_counter % n == 0)

    def _monitor_track_cov(self, cov: float) -> None:
        """Feed one frame's constraint-coverage diagnostic into the
        track_scale fallback monitor."""
        thresh = float(self.track_scale_fallback)
        if thresh <= 0 or self.track_scale_active <= 1:
            return
        if cov < thresh:
            self._low_cov_streak += 1
            if self._low_cov_streak >= int(self.fallback_patience):
                self._track_cfg = self.volume._replace(track_scale=1)
                self.num_track_scale_fallbacks += 1
                self._low_cov_streak = 0
        else:
            self._low_cov_streak = 0

    def _luma(self, color):
        luma = jnp.asarray([0.299, 0.587, 0.114], jnp.float32)
        return jnp.sum(color * luma, axis=-1)

    @property
    def pose(self):
        return self._pose_np

    @property
    def tsdf_volume(self):
        """The raw device-resident TsdfVolume (None before the seed)."""
        return self._vol

    @property
    def world_map(self):
        """Zero-level surface as a masked Cloud (extracted on access)."""
        if self._vol is None:
            return None
        return tsdf_mod.extract_surface(
            self._vol, self.volume, self.surface_capacity
        )

    @property
    def world_map_oriented(self):
        """(Cloud, normals (C, 3)) -- surface with TSDF-gradient normals
        (free-space orientation); None before the seed."""
        if self._vol is None:
            return None
        return tsdf_mod.extract_surface_oriented(
            self._vol, self.volume, self.surface_capacity
        )

    def world_mesh(self, capacity: int = 131072):
        """Zero-level surface as a TriangleMesh (marching tetrahedra over
        the fused volume; colored vertices iff use_color). None before
        the seed frame."""
        if self._vol is None:
            return None
        from realsensetracker_tpu.mapping.mesh import extract_mesh

        return extract_mesh(
            self._vol, self.volume, capacity, with_color=self.use_color
        )

    @property
    def world_map_colored(self):
        """(Cloud, colors (C, 3) in [0, 1]); None unless use_color."""
        if self._vol is None or not self.use_color:
            return None
        return tsdf_mod.extract_surface_colored(
            self._vol, self.volume, self.surface_capacity
        )

    def _color_frame(self, color):
        if not self.use_color:
            return None
        if color is None:
            raise ValueError(
                "use_color tracker: process() needs an (H, W, 3) color "
                "frame per call"
            )
        arr = np.asarray(color)
        if arr.dtype == np.uint8:
            arr = arr.astype(np.float32) / 255.0
        if arr.ndim == 2:  # gray sources fuse as a gray-shaded map
            arr = np.repeat(arr[..., None], 3, axis=-1)
        return jnp.asarray(arr, jnp.float32)

    def _as_depth(self, depth):
        """Integer (raw u16) frames stay raw for the on-device convert;
        floats pin f32 (meters)."""
        d = jnp.asarray(depth)
        if jnp.issubdtype(d.dtype, jnp.integer):
            return d
        return d.astype(jnp.float32)

    def reseed(self, depth, color=None, model_depth=None) -> None:
        """Restart the model from this frame: fresh volume fused at
        identity, pose reset. Trajectory and frame index are kept -- this
        is the submap-atlas handover primitive (mapping/submaps.py), not
        a full reset: the caller owns the world-frame bookkeeping.

        ``model_depth`` (the OLD model raycast at the handover pose,
        i.e. a synthetic frame in the NEW submap's camera frame) also
        fuses at identity: the new submap inherits the old one's fused,
        denoised surface instead of starting from one raw frame, which
        measurably cuts handover drift. On color volumes it borrows the
        raw frame's color (the two geometries coincide at this pose)."""
        color = self._color_frame(color)
        self._vol = _seed_volume(
            self._as_depth(depth), self.intr, self.volume,
            color=color, with_color=self.use_color,
            depth_scale=self.depth_scale,
        )
        if self.photometric is not None:
            self._prev_gray = self._luma(color)
        if model_depth is not None:
            self._vol = tsdf_mod.integrate(
                self._vol, jnp.asarray(model_depth, jnp.float32),
                se3.identity(), self.intr, self.volume, color=color,
            )
        self._pose = se3.identity()
        self._pose_np = np.eye(4, dtype=np.float32)
        # Fresh episode: restart the fuse cadence (the seed fused) and
        # re-arm reduced-resolution tracking (the fallback is per-map).
        self._fuse_counter = 1
        self._track_cfg = self.volume
        self._low_cov_streak = 0

    def process(self, depth, timestamp: float | None = None,
                color=None) -> FrameResult:
        if timestamp is None:
            timestamp = float(self._index)
        color = self._color_frame(color)

        if self._vol is None:
            self._vol = _seed_volume(
                self._as_depth(depth), self.intr, self.volume,
                color=color, with_color=self.use_color,
                depth_scale=self.depth_scale,
            )
            if self.photometric is not None:
                self._prev_gray = self._luma(color)
            self._pose = se3.identity()
            self._pose_np = np.eye(4, dtype=np.float32)
            self._fuse_counter = 1
            self._track_cfg = self.volume
            self._low_cov_streak = 0
            self.trajectory.append(timestamp, self._pose_np)
            res = FrameResult(
                self._pose_np, se3.identity(), True, 0.0, 1.0, self._index
            )
            self._index += 1
            return res

        out = _fused_tsdf_step(
            self._vol, self._as_depth(depth), self._pose, color,
            self._prev_gray, self._fuse_due(),
            intr=self.intr, vol_cfg=self._track_cfg, icp_cfg=self.icp,
            min_inlier_fraction=float(self.min_inlier_fraction),
            photo_cfg=self.photometric, photo_ref=self.photometric_ref,
            depth_scale=self.depth_scale,
        )
        self._fuse_counter += 1
        relative = out.relative
        self._prev_gray = out.gray
        s = np.asarray(out.stats)  # the frame's one host transfer
        rmse, inlier, ok = float(s[0]), float(s[1]), bool(s[2] > 0.5)
        self._monitor_track_cov(float(s[19]))
        self._vol = out.vol
        self._pose = out.pose
        if ok:
            self._pose_np = s[3:19].reshape(4, 4)
        self.trajectory.append(timestamp, self._pose_np)
        res = FrameResult(
            pose=self._pose_np,
            relative=relative,
            success=ok,
            rmse=rmse,
            inlier_fraction=inlier,
            frame_index=self._index,
        )
        self._index += 1
        return res

    def process_window(self, depths, timestamps=None, window: int = 8,
                       colors=None) -> list[FrameResult]:
        """Process a batch of frames, scanning up to ``window`` frames
        per device dispatch. Identical per-frame results to process()
        (the scan body is the same step math); short tails pad to the
        fixed window shape with hold-state frames so every chunk reuses
        one compiled program. Seeding (the first frame ever) happens
        per-frame, outside the scan."""
        n = len(depths)
        if timestamps is None:
            timestamps = [None] * n
        if self.use_color:
            if colors is None or len(colors) != n:
                raise ValueError(
                    "use_color tracker: process_window() needs one color "
                    "frame per depth frame"
                )
        results: list[FrameResult] = []
        i = 0
        if self._vol is None and n:
            results.append(self.process(
                depths[0], timestamps[0],
                color=colors[0] if colors is not None else None,
            ))
            i = 1
        while i < n:
            chunk = [self._as_depth(d) for d in depths[i:i + window]]
            kinds = {bool(jnp.issubdtype(c.dtype, jnp.integer))
                     for c in chunk}
            if len(kinds) > 1:
                # Mixed raw/meters chunks: jnp.stack would promote the
                # raw frames to float COUNTS misread as meters -- convert
                # the integer frames to meters first.
                chunk = [depth_to_meters(c, self.depth_scale)
                         for c in chunk]
            k = len(chunk)
            pad = window - k
            d = jnp.stack(chunk + [chunk[-1]] * pad)
            valids = jnp.arange(window) < k
            n_every = int(getattr(self.volume, "integrate_every", 1))
            fuses = None
            if n_every > 1:
                fuses = jnp.asarray([
                    (self._fuse_counter + j) % n_every == 0
                    for j in range(window)
                ])
            cols = None
            if self.use_color:
                cc = [self._color_frame(c) for c in colors[i:i + k]]
                cols = jnp.stack(cc + [cc[-1]] * pad)
            new_vol, new_pose_dev, rels, new_gray, stats = \
                _fused_tsdf_window(
                    self._vol, d, self._pose, valids, cols,
                    self._prev_gray, fuses,
                    intr=self.intr, vol_cfg=self._track_cfg,
                    icp_cfg=self.icp,
                    min_inlier_fraction=float(self.min_inlier_fraction),
                    with_color=self.use_color, photo_cfg=self.photometric,
                    photo_ref=self.photometric_ref,
                    depth_scale=self.depth_scale,
                )
            self._fuse_counter += k
            self._prev_gray = new_gray
            s = np.asarray(stats)  # the window's one host transfer
            r = np.asarray(rels)
            self._vol = new_vol
            self._pose = new_pose_dev
            for j in range(k):
                ok = bool(s[j, 2] > 0.5)
                self._monitor_track_cov(float(s[j, 19]))
                if ok:
                    self._pose_np = s[j, 3:19].reshape(4, 4)
                ts = timestamps[i + j]
                if ts is None:
                    ts = float(self._index)
                self.trajectory.append(ts, self._pose_np)
                results.append(FrameResult(
                    pose=self._pose_np,
                    relative=r[j],
                    success=ok,
                    rmse=float(s[j, 0]),
                    inlier_fraction=float(s[j, 1]),
                    frame_index=self._index,
                ))
                self._index += 1
            i += k
        return results
