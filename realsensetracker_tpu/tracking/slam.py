"""Mapping tracker: keyframe VO + loop closure + pose-graph optimization.

Completes the pipeline the reference author planned but never built
(structure.txt:1-9 lists `loop_closure`, `optimize`, `mapping` with no
implementation): keyframe odometry (tracking/keyframe.py) feeds a keyframe
database (loop_closure/detector.py); detected + verified loop closures
become edges of a pose graph optimized on-device (optimize/pose_graph.py);
the voxel world model rebuilds from optimized keyframe poses.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from realsensetracker_tpu.align import projective
from realsensetracker_tpu.api.config import AlignConfig
from realsensetracker_tpu.geometry import camera
from realsensetracker_tpu.loop_closure.detector import (
    KeyframeDatabase,
    global_descriptor,
)
from realsensetracker_tpu.ops import cloud as cloud_mod
from realsensetracker_tpu.ops import fpfh as fpfh_mod
from realsensetracker_tpu.ops import voxel as voxel_mod
from realsensetracker_tpu.optimize import pose_graph as pg
from realsensetracker_tpu.tracking.keyframe import KeyframeTracker
from realsensetracker_tpu.tracking.trajectory import Trajectory


def _prep_cloud_math(depth, *, intr, voxel_size, capacity,
                     depth_scale=1.0, prep_scale=1):
    """Depth frame -> capacity-bounded keyframe cloud (traced body).

    Raw integer frames convert to meters IN-program (half the upload
    bytes; float frames pass through). ``prep_scale`` (power of two)
    builds the cloud from the 1/prep_scale pyramid level -- the same
    validity-aware 2x2 pooling the ICP pyramid uses -- cutting the
    voxel-downsample sort rows prep_scale^2-fold (the sort is the prep
    program's dominant device cost; see SlamConfig.keyframe_prep_scale)."""
    from realsensetracker_tpu.ops.pyramid import build_pyramid, depth_to_meters

    n_levels = max(int(prep_scale).bit_length(), 1)  # 1->1, 2->2, 4->3
    levels, _ = build_pyramid(
        depth_to_meters(jnp.asarray(depth), depth_scale), intr, n_levels,
        with_normals=False,
    )
    lv = levels[n_levels - 1]
    h, w = lv.vertex_valid.shape
    pts = lv.vertex_map.reshape(h * w, 3)
    ok = lv.vertex_valid.reshape(h * w)
    c = voxel_mod.downsample_voxel(
        cloud_mod.Cloud(points=pts, mask=ok), voxel_size
    )
    # Capacity reduction must be spatially UNIFORM, not a head slice: the
    # FPFH descriptor / overlap verifier would otherwise see viewpoint-
    # dependent croppings of the same place whenever the occupied-voxel
    # count exceeds capacity (ops.cloud.subsample_to_capacity).
    return cloud_mod.subsample_to_capacity(c, capacity)


def _prep_features_math(kf_cloud, *, normal_k, feature_radius,
                        max_neighbors):
    """Keyframe cloud -> (FPFH features, place descriptor) (traced
    body)."""
    feats = fpfh_mod.compute_fpfh(
        kf_cloud, jnp.zeros(3, jnp.float32), normal_k, feature_radius,
        max_neighbors,
    )
    desc = global_descriptor(feats, kf_cloud.mask)
    return feats, desc


@partial(jax.jit, static_argnames=("intr", "voxel_size", "capacity",
                                   "depth_scale", "prep_scale"))
def _keyframe_prep_cloud(depth, *, intr, voxel_size, capacity,
                         depth_scale=1.0, prep_scale=1):
    """Stage-A prep program: unproject + voxel downsample + capacity
    slice. The deferred-booking pipeline fires this on the EVENT frame
    and the feature program one frame later, so each intervening frame's
    stats fence absorbs only its share of the prep's device time
    (round-5 event-offset profiling: prep absorbs cheaply at event+1/+2;
    the tail lived at event+3 where verify device time stacked on the
    collect round-trip -- see the wait stage in _advance_pending)."""
    return _prep_cloud_math(depth, intr=intr, voxel_size=voxel_size,
                            capacity=capacity, depth_scale=depth_scale,
                            prep_scale=prep_scale)


@partial(jax.jit, static_argnames=("normal_k", "feature_radius",
                                   "max_neighbors"))
def _keyframe_prep_features(kf_cloud, *, normal_k, feature_radius,
                            max_neighbors):
    """Stage-B prep program: FPFH + pooled place descriptor on the
    device-resident stage-A cloud."""
    return _prep_features_math(kf_cloud, normal_k=normal_k,
                               feature_radius=feature_radius,
                               max_neighbors=max_neighbors)


@partial(jax.jit, static_argnames=("intr", "voxel_size", "normal_k",
                                   "feature_radius", "max_neighbors",
                                   "capacity", "depth_scale",
                                   "prep_scale"))
def _fused_keyframe_prep(depth, *, intr, voxel_size, normal_k,
                         feature_radius, max_neighbors, capacity,
                         depth_scale=1.0, prep_scale=1):
    """Depth frame -> (keyframe cloud, FPFH features, place descriptor) as
    ONE XLA program: unproject, voxel downsample, capacity slice, FPFH,
    descriptor pooling, as one dispatch instead of one per eager op.
    Used by the synchronous paths (relocalization, sync booking); the
    deferred pipeline uses the split stage-A/stage-B programs above."""
    kf_cloud = _prep_cloud_math(depth, intr=intr, voxel_size=voxel_size,
                                capacity=capacity,
                                depth_scale=depth_scale,
                                prep_scale=prep_scale)
    feats, desc = _prep_features_math(
        kf_cloud, normal_k=normal_k, feature_radius=feature_radius,
        max_neighbors=max_neighbors,
    )
    return kf_cloud, feats, desc


@dataclass
class SlamConfig:
    intrinsics: camera.Intrinsics = camera.TUM_DEFAULT
    icp: projective.ProjectiveIcpConfig = projective.ProjectiveIcpConfig()
    align: AlignConfig = field(default_factory=AlignConfig)
    loop_similarity: float = 0.95
    loop_min_separation: int = 5  # in keyframes
    loop_noise_bound: float = 0.25
    # Loop edges are ICP-refined but still less precise than consecutive-
    # frame odometry (partial overlap). 0.25 measured best across regimes
    # on 40-frame loop trajectories: with DRIFTY odometry it corrects most
    # (18.2 -> 12.6 mm ATE vs 13.1 at weight 1.0), with sub-mm odometry it
    # degrades least (4.2 -> 4.7 mm vs 6.1 at weight 1.0).
    loop_weight: float = 0.25
    # Verifier acceptance: symmetric cloud-overlap fraction under the
    # estimated loop transform (loop_closure/detector.py verify()). This is
    # the check that rejects confident-wrong registrations on self-similar
    # geometry; tau should track the keyframe voxel size.
    loop_overlap_tau: float = 0.05
    loop_min_overlap: float = 0.6
    # Odometry gate: reject loop transforms that contradict the current
    # trajectory estimate by more than this twist norm (drift bound). The
    # allowance GROWS with keyframe separation (gate + drift_per_keyframe
    # * |i - j|): odometry drift is unbounded over time, so a fixed gate
    # rejects every TRUE loop precisely when tracking has drifted far and
    # re-anchoring matters most -- measured on a 500-frame aggressive
    # sweep, a fixed 0.3 gate let only 7 loops through after meter-scale
    # drift. Geometric verification (symmetric overlap) remains the
    # primary wrong-loop rejector; the gate is near-range safety only.
    loop_odometry_gate: float = 0.3
    loop_drift_per_keyframe: float = 0.05
    # Online optimization: every N keyframes (when loop edges exist), run
    # pose-graph optimization in-stream and feed the latest keyframe's
    # correction back into the VO (see _optimize_online). 0 = only on
    # demand via optimize().
    optimize_every: int = 0
    keyframe_cloud_capacity: int = 4096
    # Relocalization: when local projective ICP loses tracking for a full
    # failure streak (KeyframeTracker.max_consecutive_failures) the VO
    # layer re-seeds holding a stale pose; with relocalize=True the SLAM
    # layer instead registers the current frame against recent keyframes
    # with the robust global pipeline (FPFH + GNC-TLS + ICP refine -- the
    # reference's TEASER recovery role, rs_align_app.cpp:310-314) and, if
    # the symmetric-overlap verifier accepts, hands the recovered pose
    # back to the VO (KeyframeTracker.relocalize_to).
    relocalize: bool = True
    # Candidates per attempt: the most recent keyframes plus the best
    # place-recognition (descriptor) hit anywhere in the map -- after a
    # long blind stretch the camera may resurface at a place from an
    # earlier pass, not near the latest keyframes.
    reloc_candidates: int = 3
    # Lost mode: if the attempt at the failure-streak re-seed does not
    # verify (typical mid-burst: no view overlap yet), keep retrying --
    # on every new keyframe and every reloc_retry_every-th frame -- until
    # one verifies. Local tracking meanwhile resumes RELATIVE to the
    # stale pose, so the first verified relocalization snaps the
    # trajectory back.
    reloc_retry_every: int = 5
    # The odometry edge INTO a relocalized keyframe measures stale-held
    # drift plus unobserved real motion -- garbage. The verified
    # relocalization registration is recorded as a LOOP edge to the
    # keyframe it matched (that edge carries the actual information);
    # the jump chain edge is floored to this weight so it cannot drag
    # the graph. Measured on a 500-frame aggressive synthetic sweep:
    # keeping the jump edge at loop_weight
    # 0.25 poisons optimization (keyframe ATE 1062 -> 1285 mm, WORSE
    # than no optimization, even with oracle-true loop edges); flooring
    # it recovers 1285 -> 780 mm, within 30 mm of the oracle-loop bound.
    reloc_odom_weight: float = 0.02
    # RGB-D odometry: when True, process() takes (depth, gray) and the VO
    # is the joint geometric+photometric keyframe tracker
    # (tracking/keyframe_rgbd.py). On geometry-degenerate stretches the
    # photometric term pins the in-plane motion point-to-plane cannot
    # observe -- the structural fix for the sliding ambiguity of the
    # seed-11 synthetic scene. Loop closure, verification
    # and relocalization stay geometric (FPFH on the depth cloud) and work
    # unchanged.
    use_rgb: bool = False
    rgbd: "object" = None  # align.rgbd.RgbdIcpConfig; None -> defaults
    # Retain each keyframe's raw depth frame (host-side float32) so the
    # loop-consistent trajectory can be re-fused into a DENSE model after
    # optimization (build_dense/world_mesh): the classic
    # offline-reconstruction step KinectFusion-style trackers cannot do
    # (their volume is fused at drifted poses and never corrected).
    # Off by default: ~H*W*4 bytes per keyframe of host memory.
    keep_depths: bool = False
    # Meters per raw unit for INTEGER depth frames (RealSense Z16 1 mm;
    # TUM PNGs 1/5000). The hot VO path forwards raw uint16 to the device
    # (half the upload bytes -- tracking/keyframe.py); host-side SLAM
    # logic (relocalization clouds, keyframe features, kept depths)
    # converts lazily, only at keyframe/relocalization events.
    depth_scale: float = 1e-3
    # Windowed processing (process_window): with True (default), keyframe
    # PROMOTIONS are consumed in-scan (truncate_at_events="failures" --
    # the window only truncates at recovery re-seeds, where relocalization
    # must act) and their host bookkeeping (loop closure, graph edges)
    # runs after the dispatch from the per-row stats. Exactly 1/W
    # dispatches per frame instead of truncating at every ~6th frame
    # (measured +27% scan waste with events every ~6 frames).
    # Semantics are identical to per-frame processing EXCEPT when
    # optimize_every > 0: the online drift correction then applies at the
    # window boundary instead of mid-window (bounded by one window of
    # staleness). Set False for strict per-frame-identical behavior.
    window_defer_events: bool = True
    # PER-FRAME keyframe booking pipeline (the serving pending_seed
    # pattern applied to SLAM): on a clean keyframe promotion the
    # stage-A prep program (unproject + voxel downsample + capacity)
    # fires WITHOUT materializing and the event's work spreads over the
    # next THREE frames -- t+1 fires the stage-B prep (FPFH +
    # descriptor) on the device-resident cloud (stage-A's device time
    # rode t+1's VO fence); t+2 runs place recognition, inserts the
    # keyframe, and FIRES loop verification (stage-B rode t+2's fence);
    # t+3 is a WAIT frame (the verification program's device time rides
    # its fence); t+4 collects the verdicts and books the loop edges.
    # The ~265 ms p90 spike of paying prep + query + verify + booking
    # on one frame spreads into five slices; round-5 event-offset
    # profiling located the residual ~135 ms tail as the event+3 frame
    # absorbing verify device time AND the ~45 ms collect round-trip
    # together -- hence the wait frame. Every quantity is measured at
    # event time (pose/span snapshots), so keyframes, loop edges, and
    # the optimized trajectory are IDENTICAL to synchronous booking --
    # only the frame on which the host learns each verdict moves (and
    # optimize_every corrections land <= 4 frames later). Reads
    # (keyframe_count, optimize, world maps) and
    # events that need current state (new keyframes, relocalization,
    # lost mode) flush the pipeline first. Windowed processing ignores
    # this (windows already amortize events).
    defer_keyframe_booking: bool = True
    # Keyframe-cloud build resolution divisor (power of two). The prep
    # program's dominant device cost is the voxel-downsample SORT over
    # H*W unprojected pixels; at 2 the cloud builds from the half-res
    # pyramid level (the ICP's own validity-aware 2x2 pooling), cutting
    # sort rows 4x. With a 5 cm keyframe voxel the occupied-voxel set
    # barely changes (several source pixels per voxel either way), but
    # clouds are NOT bit-identical to prep_scale=1 -- this is an
    # explicit latency knob, not a free default. Applies to keyframe
    # prep AND relocalization (both must see the same cloud geometry).
    keyframe_prep_scale: int = 1


def _se3_log_np(T: np.ndarray) -> np.ndarray:
    """Host-side SE(3) log in NumPy -- [tx ty tz rx ry rz], translation
    first, matching geometry.se3.log's twist layout.

    The loop-closure odometry gate needs one twist norm per verified hit;
    calling the un-jitted device se3.log there cost ~20 eager dispatches
    per hit. Near theta = pi the
    rotation axis is ill-conditioned -- return an inf twist, which the gate
    (a drift bound well under pi) rejects anyway."""
    R = np.asarray(T[:3, :3], np.float64)
    t = np.asarray(T[:3, 3], np.float64)
    c = np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0)
    theta = float(np.arccos(c))
    if theta < 1e-7:
        w_hat = 0.5 * (R - R.T)
        w = np.array([w_hat[2, 1], w_hat[0, 2], w_hat[1, 0]])
        return np.concatenate([t, w])
    s = np.sin(theta)
    if abs(s) < 1e-6:
        return np.full(6, np.inf)
    w_hat = (R - R.T) * (theta / (2.0 * s))
    w = np.array([w_hat[2, 1], w_hat[0, 2], w_hat[1, 0]])
    V_inv = (
        np.eye(3)
        - 0.5 * w_hat
        + (1.0 / theta**2)
        * (1.0 - theta * s / (2.0 * (1.0 - np.cos(theta))))
        * (w_hat @ w_hat)
    )
    return np.concatenate([V_inv @ t, w])


@dataclass
class _Keyframe:
    index: int  # keyframe index (graph node id)
    frame_index: int
    pose: np.ndarray  # world_from_keyframe (updated by optimization)
    cloud: object
    feats: object
    # Odometry measurement prev_kf^-1 @ this, captured AT INSERTION: the
    # graph must be rebuilt from these originals, not re-extracted from
    # (possibly already-optimized) poses -- see pose_graph.from_trajectory.
    odom_from_prev: np.ndarray | None = None
    # Confidence of that edge: 1.0 for a clean tracked span, reduced when
    # the span contained tracking failures (held pose misses real motion).
    odom_weight: float = 1.0
    # Raw (H, W) float32 depth, kept only under SlamConfig.keep_depths
    # (post-optimization dense re-fusion).
    depth: np.ndarray | None = None


class SlamTracker:
    """Streaming SLAM: depth frames in -> loop-consistent trajectory out."""

    # Raw integer frames are accepted: the VO converts on device, host
    # SLAM logic converts lazily (see SlamConfig.depth_scale).
    accepts_raw_depth = True

    def __init__(self, config: SlamConfig | None = None):
        self.config = config or SlamConfig()
        if self.config.use_rgb:
            from realsensetracker_tpu.align.rgbd import RgbdIcpConfig
            from realsensetracker_tpu.tracking.keyframe_rgbd import (
                RgbdKeyframeTracker,
            )

            self._vo = RgbdKeyframeTracker(
                self.config.intrinsics, self.config.rgbd or RgbdIcpConfig()
            )
        else:
            self._vo = KeyframeTracker(self.config.intrinsics, self.config.icp,
                                       depth_scale=self.config.depth_scale)
        self._db = KeyframeDatabase(
            min_separation=self.config.loop_min_separation,
            similarity_threshold=self.config.loop_similarity,
        )
        self._keyframes: list[_Keyframe] = []
        self._loop_edges: list[tuple] = []  # (kf_i, kf_j, T_ij, weight)
        self._num_loop_closures = 0
        self.num_relocalizations = 0
        self._num_online_optimizations = 0
        self.lost = False  # un-relocalized tracking loss: pose is stale
        self._frame_count = 0
        # Deferred-window bookkeeping: the optimize_every cadence fired
        # inside a window and runs once at the window boundary.
        self._optimize_due = False
        # Per-frame booking pipeline (SlamConfig.defer_keyframe_booking):
        # at most one in-flight keyframe, advancing one stage per frame.
        self._pending_kf: dict | None = None

    @property
    def trajectory(self) -> Trajectory:
        return self._vo.trajectory

    @property
    def keyframe_count(self) -> int:
        self.flush_pending()
        return len(self._keyframes)

    # Counters read by CLIs/tests after a stream: flush so a still-
    # pipelined final keyframe's loop edges are never missing from the
    # count. Setters keep checkpoint restore (load_slam) working.
    @property
    def num_loop_closures(self) -> int:
        self.flush_pending()
        return self._num_loop_closures

    @num_loop_closures.setter
    def num_loop_closures(self, v) -> None:
        self._num_loop_closures = int(v)

    @property
    def num_online_optimizations(self) -> int:
        self.flush_pending()
        return self._num_online_optimizations

    @num_online_optimizations.setter
    def num_online_optimizations(self, v) -> None:
        self._num_online_optimizations = int(v)

    def _meters(self, depth):
        """Lazy host conversion of raw integer frames to f32 meters --
        called only where SLAM logic consumes depth on host (keyframe
        events, relocalization), so the per-frame hot path never pays it."""
        from realsensetracker_tpu.data.depth_units import to_meters_np

        return to_meters_np(depth, self.config.depth_scale)

    def process(self, depth, timestamp: float | None = None, gray=None):
        if self.config.use_rgb:
            if gray is None:
                raise ValueError(
                    "SlamConfig.use_rgb=True: process() needs gray frames"
                )
            from realsensetracker_tpu.api.tracker import _as_gray

            # The RGB-D VO has no raw path: convert on host.
            res = self._vo.process(self._meters(depth), _as_gray(gray),
                                   timestamp)
        else:
            res = self._vo.process(depth, timestamp)
        self._frame_count += 1
        return self._post_frame(
            depth, res,
            defer_booking=self.config.defer_keyframe_booking,
        )

    def process_window(self, depths, timestamps=None, window: int = 8,
                       grays=None):
        """Process a batch of frames, scanning up to `window` frames per
        device dispatch (KeyframeTracker/RgbdKeyframeTracker
        process_window; SlamConfig.use_rgb selects RGB-D and requires
        `grays`).

        With window_defer_events=True (default; depth-only and RGB-D):
        the scan truncates only at recovery re-seeds (relocalization
        must act there); keyframe promotions are consumed in-scan and
        their host bookkeeping (loop closure, graph edges, optimize
        cadence) runs after the dispatch from the per-row stats --
        exactly 1/W dispatches per frame. Identical to per-frame
        processing except that optimize_every>0 corrections apply at
        window boundaries.

        With window_defer_events=False: the VO scan truncates at every
        keyframe event, so all host-side SLAM logic runs at exactly the
        same frames with the same state. While lost (un-relocalized
        tracking loss) processing falls back to per-frame so the
        relocalization retry cadence is preserved. Returns one result
        per frame.
        """
        if self.config.use_rgb and grays is None:
            raise ValueError(
                "SlamConfig.use_rgb=True: process_window() needs grays"
            )
        # Mixed process()/process_window() use: windowed bookkeeping
        # needs fully-booked state.
        self.flush_pending()
        if timestamps is None:
            timestamps = [None] * len(depths)
        defer = self.config.window_defer_events
        results = []
        i = 0
        while i < len(depths):
            if self.lost:
                if self.config.use_rgb:
                    results.append(
                        self.process(depths[i], timestamps[i], gray=grays[i])
                    )
                else:
                    results.append(self.process(depths[i], timestamps[i]))
                i += 1
                continue
            if self.config.use_rgb:
                from realsensetracker_tpu.api.tracker import _as_gray

                consumed = self._vo.process_window(
                    [self._meters(d) for d in depths[i : i + window]],
                    [_as_gray(g) for g in grays[i : i + window]],
                    timestamps[i : i + window],
                    pad_to=window,
                    truncate_at_events="failures" if defer else True,
                )
            else:
                consumed = self._vo.process_window(
                    depths[i : i + window], timestamps[i : i + window],
                    pad_to=window,
                    truncate_at_events="failures" if defer else True,
                )
            self._frame_count += len(consumed)
            if defer:
                # Promotions were consumed in-scan: run each one's host
                # bookkeeping now, in frame order. Only the LAST row can
                # be a failure re-seed (the scan latches there), so the
                # relocalization branch inside _post_frame still acts at
                # the truncation point exactly as per-frame would.
                # Online optimization is held until ALL of the window's
                # keyframes are booked: running it between two same-window
                # events would rewrite keyframe k's stored pose while
                # k+1's in-scan pose is already fixed, contaminating the
                # odometry edge between them with the correction delta --
                # the edges must be measured in ONE drift frame, and the
                # correction then applies once at the window boundary.
                opt_due = False
                for j, res in enumerate(consumed):
                    if res.is_new_keyframe:
                        consumed[j] = self._post_frame(
                            depths[i + j], res, defer_optimize=True
                        )
                        opt_due = opt_due or self._optimize_due
                        self._optimize_due = False
                if opt_due:
                    self._optimize_online()
            else:
                res = consumed[-1]
                if res.is_new_keyframe:
                    consumed[-1] = self._post_frame(
                        depths[i + len(consumed) - 1], res
                    )
            results.extend(consumed)
            i += len(consumed)
        return results

    def flush_pending(self) -> None:
        """Run the deferred-booking pipeline to completion (no-op when
        empty). Called before anything that must see current keyframe /
        loop-edge state: new events, relocalization, optimization, map
        extraction, keyframe_count."""
        while self._pending_kf is not None:
            self._advance_pending()

    def _advance_pending(self) -> None:
        """Advance the deferred keyframe one pipeline stage."""
        p = self._pending_kf
        if p is None:
            return
        if p["stage"] == 1:
            self._pending_fire_features()
        elif p["stage"] == 2:
            self._pending_stage2()
        elif p["stage"] == 3:
            # Wait frame: the verification program fired at the previous
            # stage EXECUTES on the serial device behind THIS frame's VO
            # fence (~its device time); collecting on the same frame
            # would stack the ~45 ms materialization round-trip on top
            # (measured: the event+3 frame carried the whole residual
            # p90 tail at ~135 ms). One no-op stage splits absorb and
            # collect across two frames.
            p["stage"] = 4
        else:
            self._pending_stage3()

    def _defer_keyframe(self, depth, res) -> None:
        """Stage 1 (the event frame): fire the stage-A prep dispatch
        (unproject + voxel downsample + capacity) without materializing
        and snapshot every event-time quantity the later stages need.
        Costs the event frame only the dispatch submission; the stage-A
        device time rides the NEXT frame's stats fence."""
        cfg = self.config
        span = getattr(res, "span_failures", None)
        if span is None:
            span = self._vo.last_span_failures
        self._pending_kf = {
            "stage": 1,
            "cloud": _keyframe_prep_cloud(
                depth,
                intr=cfg.intrinsics,
                voxel_size=float(cfg.align.voxel_size),
                capacity=int(cfg.keyframe_cloud_capacity),
                depth_scale=float(cfg.depth_scale),
                prep_scale=int(cfg.keyframe_prep_scale),
            ),
            "pose": np.asarray(res.pose, np.float64),
            "frame_index": int(res.frame_index),
            "span": int(span),
            "depth": depth if self.config.keep_depths else None,
        }

    def _pending_fire_features(self) -> None:
        """Stage 1.5 (one frame later): fire the stage-B prep program
        (FPFH + descriptor) on the device-resident stage-A cloud --
        submission only, no materialization; its device time rides the
        FOLLOWING frame's fence. Splitting the prep across two fences is
        what moved the residual p90 spike off the keyframe frame (the
        whole fused prep behind one fence made one slow frame)."""
        cfg = self.config
        p = self._pending_kf
        p["feat"] = _keyframe_prep_features(
            p["cloud"],
            normal_k=int(cfg.align.normal_k),
            feature_radius=float(cfg.align.feature_radius),
            max_neighbors=int(cfg.align.fpfh_max_neighbors),
        )
        p["stage"] = 2

    def _pending_stage2(self) -> None:
        """Stage 2 (two frames after the event): place recognition on
        the (now device-complete) prep, keyframe + odometry-edge
        insertion, and the loop-verification dispatch -- fired, not
        materialized."""
        cfg = self.config
        p = self._pending_kf
        cloud = p["cloud"]
        feats, desc = p["feat"]
        kf_idx = len(self._keyframes)
        pose = p["pose"]
        kf = _Keyframe(
            index=kf_idx,
            frame_index=p["frame_index"],
            pose=pose.astype(np.float32),
            cloud=cloud,
            feats=feats,
            odom_from_prev=(
                (np.linalg.inv(self._keyframes[-1].pose.astype(np.float64))
                 @ pose).astype(np.float32)
                if self._keyframes else None
            ),
            odom_weight=max(0.02, 1.0 / (1.0 + p["span"])),
            depth=(
                np.asarray(self._meters(p["depth"]), np.float32)
                if cfg.keep_depths else None
            ),
        )
        hits = self._db.query(kf_idx, cloud, feats, desc=desc)
        p["verify"] = self._db.verify_batch_async(
            kf_idx, cloud, feats, [c for c, _ in hits],
            noise_bound=cfg.loop_noise_bound,
            overlap_tau=cfg.loop_overlap_tau,
            min_overlap=cfg.loop_min_overlap,
            pad_to=3,
        )
        self._db.add(kf_idx, cloud, feats)
        self._keyframes.append(kf)
        p["kf_idx"] = kf_idx
        p["stage"] = 3

    def _pending_stage3(self) -> None:
        """Final stage (four frames after the event): collect the loop
        verdicts (device-complete behind the wait frame's VO dispatch),
        book accepted edges, run the optimize cadence."""
        from realsensetracker_tpu.loop_closure.detector import (
            KeyframeDatabase,
        )

        cfg = self.config
        p = self._pending_kf
        self._pending_kf = None
        kf_idx = p["kf_idx"]
        if p["verify"] is not None:
            T_dev, ok_dev, kept = p["verify"]
            verdicts = KeyframeDatabase.finish_verify(T_dev, ok_dev, kept)
            self._book_loop_edges(
                kf_idx, p["pose"].astype(np.float32),
                list(zip(kept, verdicts)), reloc_edge=None,
            )
        ev = cfg.optimize_every
        if (
            ev
            and len(self._keyframes) >= 2
            and len(self._keyframes) % ev == 0
            and self._loop_edges
        ):
            self._optimize_online()

    def _post_frame(self, depth, res, defer_optimize=False,
                    defer_booking=False):
        """Everything process() does after the VO step: relocalization,
        keyframe events (loop closure + graph edges), online optimization.

        defer_optimize: record that the optimize_every cadence fired
        (self._optimize_due) instead of running it -- the deferred-window
        path batches all of a window's keyframe bookkeeping first and
        optimizes once at the boundary (see process_window).

        defer_booking: clean keyframe promotions enter the 3-stage
        booking pipeline (SlamConfig.defer_keyframe_booking) instead of
        booking synchronously; every path that needs current state
        flushes first, so results are identical."""
        precomputed = None
        odom_weight = None  # None -> derive from the span's failure count
        # A failure-streak re-seed means the held pose is stale: attempt
        # relocalization now, and -- if it does not verify (typical
        # mid-burst) -- enter lost mode and keep retrying until one does.
        reseed_fail = res.is_new_keyframe and not res.success
        retry = self.lost and (
            res.is_new_keyframe
            or self._frame_count % max(self.config.reloc_retry_every, 1) == 0
        )
        if res.is_new_keyframe or reseed_fail or retry or self.lost:
            # Events must see fully-booked state (candidate stores, graph
            # indices, keyframe list).
            self.flush_pending()
        else:
            self._advance_pending()
        reloc_edge = None
        if self.config.relocalize and self._keyframes and (reseed_fail or retry):
            pose, precomputed, reloc_edge = self._try_relocalize(depth)
            if pose is not None:
                self._vo.relocalize_to(pose)
                self.num_relocalizations += 1
                self.lost = False
                # Force a keyframe at the recovery point so the graph gets
                # a node there. The chain edge into it measures held-stale
                # drift + unobserved motion (garbage) -> floored weight;
                # the verified registration itself becomes a LOOP edge to
                # the matched keyframe (added in _on_keyframe), which is
                # where the recovery information actually lives.
                res = res._replace(
                    pose=np.asarray(pose, np.float32), is_new_keyframe=True
                )
                odom_weight = self.config.reloc_odom_weight
            else:
                reloc_edge = None
                if reseed_fail:
                    self.lost = True
        if res.is_new_keyframe:
            if (
                defer_booking
                and res.success
                and precomputed is None
                and odom_weight is None
                and reloc_edge is None
            ):
                # Clean promotion: pipeline it (stages 2-3 run on the
                # next two frames, overlapped with their VO dispatches).
                self._defer_keyframe(depth, res)
                return res
            self._on_keyframe(
                depth, res, precomputed=precomputed,
                odom_weight=odom_weight, reloc_edge=reloc_edge,
            )
            ev = self.config.optimize_every
            if (
                ev
                and len(self._keyframes) >= 2
                and len(self._keyframes) % ev == 0
                and self._loop_edges
            ):
                if defer_optimize:
                    self._optimize_due = True
                else:
                    self._optimize_online()
        return res

    def _optimize_online(self) -> None:
        """Periodic in-stream pose-graph optimization (optimize_every):
        optimize the keyframe graph, then left-multiply the latest
        keyframe's correction into the VO so tracking continues from the
        drift-corrected trajectory instead of only fixing it post-hoc."""
        old_last = self._keyframes[-1].pose.astype(np.float64).copy()
        opt = self.optimize(pad=True)
        if opt is None or not np.isfinite(opt).all():
            return
        delta = opt[-1].astype(np.float64) @ np.linalg.inv(old_last)
        self._vo.apply_world_correction(delta.astype(np.float32))
        self._num_online_optimizations += 1

    def _try_relocalize(self, depth):
        """Robust global registration of the current frame against the most
        recent keyframes; returns (world_pose | None, (cloud, feats),
        (matched_kf_index, T_cur_to_kf) | None)."""
        cfg = self.config
        cloud, feats, desc = self._prepare(depth)
        n_recent = max(cfg.reloc_candidates - 1, 1)
        cands = [kf.index for kf in self._keyframes[-n_recent:]]
        cands.reverse()  # newest first: most likely overlap
        # Plus the best place-recognition hits anywhere in the map (the
        # query frame id is far from every keyframe id, so the temporal-
        # separation filter never rejects).
        for cand_id, _sim in self._db.query(1 << 30, cloud, feats,
                                            top_k=cfg.reloc_candidates,
                                            desc=desc):
            if cand_id not in cands and len(cands) < cfg.reloc_candidates:
                cands.append(cand_id)
        # Same verifier (and therefore the SAME compiled program) as loop
        # closure: symmetric-overlap acceptance rejects confidently wrong
        # registrations, so a failed relocalization holds the pose rather
        # than corrupting it.
        verdicts = self._db.verify_batch(
            -1, cloud, feats, cands,
            noise_bound=cfg.loop_noise_bound,
            overlap_tau=cfg.loop_overlap_tau,
            min_overlap=cfg.loop_min_overlap,
            pad_to=max(3, cfg.reloc_candidates),
        )
        for kf_i, (T_cur_to_kf, ok) in zip(cands, verdicts):
            if ok:
                T = np.asarray(T_cur_to_kf)
                pose = self._keyframes[kf_i].pose @ T
                return pose, (cloud, feats, desc), (kf_i, T)
        return None, (cloud, feats, desc), None

    def _prepare(self, depth):
        """(cloud, feats, descriptor) for the current frame -- one
        dispatch. Raw integer frames upload as-is and convert in-program
        (half the event-path upload bytes)."""
        cfg = self.config
        return _fused_keyframe_prep(
            depth,
            intr=cfg.intrinsics,
            voxel_size=float(cfg.align.voxel_size),
            normal_k=int(cfg.align.normal_k),
            feature_radius=float(cfg.align.feature_radius),
            max_neighbors=int(cfg.align.fpfh_max_neighbors),
            capacity=int(cfg.keyframe_cloud_capacity),
            depth_scale=float(cfg.depth_scale),
            prep_scale=int(cfg.keyframe_prep_scale),
        )

    def _on_keyframe(self, depth, res, precomputed=None, odom_weight=None,
                     reloc_edge=None) -> None:
        """Synchronous keyframe booking (``depth`` may be raw integer:
        the prep converts in-program; keep_depths converts on host)."""
        cfg = self.config
        kf_idx = len(self._keyframes)
        if odom_weight is None:
            # Discount the incoming odometry edge by the tracking failures
            # in its span: each failed frame held the pose while the
            # camera kept moving, so the measured relative motion is
            # incomplete. Clean spans keep weight 1.0. The span comes from
            # the result row (exact per event, even when a deferred window
            # consumed several promotions); tracker.last_span_failures is
            # the fallback for results predating the field.
            span = getattr(res, "span_failures", None)
            if span is None:
                span = self._vo.last_span_failures
            odom_weight = max(0.02, 1.0 / (1.0 + span))
        if precomputed is not None:  # reuse the relocalization attempt's work
            cloud, feats, desc = precomputed
        else:
            cloud, feats, desc = self._prepare(depth)
        pose = np.asarray(res.pose, np.float64)
        kf = _Keyframe(
            index=kf_idx,
            frame_index=res.frame_index,
            pose=pose.astype(np.float32),
            cloud=cloud,
            feats=feats,
            odom_from_prev=(
                (np.linalg.inv(self._keyframes[-1].pose.astype(np.float64)) @ pose)
                .astype(np.float32)
                if self._keyframes
                else None
            ),
            odom_weight=float(odom_weight),
            depth=(
                np.asarray(self._meters(depth), np.float32)
                if cfg.keep_depths else None
            ),
        )
        # Query BEFORE adding (never match self). All candidates of this
        # query verify in ONE vmapped device dispatch (verify_batch), so
        # loop-closure cost per keyframe is independent of candidate count.
        hits = self._db.query(kf_idx, cloud, feats, desc=desc)
        verdicts = self._db.verify_batch(
            kf_idx, cloud, feats, [c for c, _ in hits],
            noise_bound=cfg.loop_noise_bound,
            overlap_tau=cfg.loop_overlap_tau,
            min_overlap=cfg.loop_min_overlap,
            pad_to=3,  # one compiled program regardless of candidate count
        )
        self._book_loop_edges(
            kf_idx, np.asarray(res.pose),
            list(zip([c for c, _ in hits], verdicts)), reloc_edge,
        )
        self._db.add(kf_idx, cloud, feats)
        self._keyframes.append(kf)

    def _book_loop_edges(self, kf_idx, kf_pose, cand_verdicts,
                         reloc_edge=None) -> None:
        """Gate + record accepted loop edges for keyframe kf_idx.
        cand_verdicts: [(cand_idx, (T_ab, ok)), ...]; kf_pose is the
        keyframe's EVENT-TIME world pose (the odometry gate must compare
        in the drift frame the measurement was made in). Shared by
        synchronous booking and pipeline stage 3."""
        cfg = self.config
        added_pairs = set()
        for cand_idx, (T_ab, ok) in cand_verdicts:
            if ok:
                # verify() registers this kf (src) onto the candidate (dst),
                # returning T mapping this-kf coords -> candidate coords.
                # The pose-graph edge (i=cand, j=this) measures
                # T_i^-1 T_j = cand_from_this, which is exactly that T.
                T_meas = np.asarray(T_ab)
                # Odometry gate: a true loop transform agrees with the
                # current estimate up to accumulated drift; confidently
                # wrong global registrations do not. Host-side log: one
                # device se3.log here costs ~20 eager dispatches.
                pred = np.linalg.inv(self._keyframes[cand_idx].pose) @ (
                    np.asarray(kf_pose)
                )
                delta = _se3_log_np(np.linalg.inv(T_meas) @ pred)
                allowed = cfg.loop_odometry_gate + (
                    cfg.loop_drift_per_keyframe * abs(kf_idx - cand_idx)
                )
                if np.linalg.norm(delta) > allowed:
                    continue
                self._loop_edges.append(
                    (cand_idx, kf_idx, T_meas, cfg.loop_weight)
                )
                added_pairs.add((int(cand_idx), kf_idx))
                self._num_loop_closures += 1
        if reloc_edge is not None and (
            (int(reloc_edge[0]), kf_idx) not in added_pairs
        ):
            # Verified relocalization measurement cand_from_this: the SAME
            # quantity a loop edge measures, produced by the same verifier.
            # Recording it here (instead of trusting the jump chain edge)
            # is what lets optimization re-anchor the post-recovery
            # segment; see SlamConfig.reloc_odom_weight. Skipped when the
            # place-recognition pass above already added the identical
            # (cand, this) edge -- a duplicate would silently double
            # loop_weight exactly on post-recovery edges.
            cand_idx, T_reloc = reloc_edge
            self._loop_edges.append(
                (int(cand_idx), kf_idx, np.asarray(T_reloc, np.float32),
                 cfg.loop_weight)
            )
            self._num_loop_closures += 1

    def optimize(self, gn_iters: int = 10, cg_iters: int = 60, pad: bool = False):
        """Run pose-graph optimization over keyframes; returns optimized
        keyframe poses (K, 4, 4). Loop edges measured candidate<-this.

        The graph is built from the odometry measurements CAPTURED AT
        INSERTION (kf.odom_from_prev), so repeated calls keep optimizing
        against the original measurements instead of re-extracting them
        from already-optimized poses.

        pad: round the node/edge counts up to capacity steps (powers of
        two) with inert padding -- identical results, but every program
        shape repeats across calls, so ONLINE optimization (which runs
        every few keyframes) costs one compile per capacity
        doubling instead of one per keyframe count."""
        self.flush_pending()
        if len(self._keyframes) < 2:
            return np.stack([k.pose for k in self._keyframes]) if self._keyframes else None
        K = len(self._keyframes)
        poses = np.stack([k.pose for k in self._keyframes]).astype(np.float32)
        odom = [k.odom_from_prev for k in self._keyframes[1:]]
        odom_w = [k.odom_weight for k in self._keyframes[1:]]
        loops = [(i, j, np.asarray(T, np.float32), w)
                 for (i, j, T, w) in self._loop_edges]
        n_pad = K
        if pad:
            eye = np.eye(4, dtype=np.float32)
            n_pad = max(8, 1 << (K - 1).bit_length())
            if n_pad > K:
                poses = np.concatenate(
                    [poses, np.repeat(poses[-1][None], n_pad - K, axis=0)]
                )
                odom = odom + [eye] * (n_pad - K)
                odom_w = odom_w + [0.0] * (n_pad - K)
            ne = max(len(loops), 1)
            e_pad = max(4, 1 << (ne - 1).bit_length())
            # (0, 0) self-edges have identically zero residual and gradient
            # at any weight: inert edge padding.
            loops = loops + [(0, 0, eye, 0.0)] * (e_pad - len(loops))
        # Padded chain edges get weight 0: the padded subspace then
        # decouples EXACTLY (its residuals, gradient, and CG Krylov
        # vectors are identically zero), so padding cannot perturb the
        # real solution.
        graph = pg.from_trajectory(
            jnp.asarray(poses),
            loop_edges=[(i, j, jnp.asarray(T), w) for (i, j, T, w) in loops],
            odometry=[jnp.asarray(T) for T in odom],
            odometry_weights=odom_w,
        )
        opt_poses, _cost = pg.optimize_pose_graph(
            graph, gn_iters=gn_iters, cg_iters=cg_iters
        )
        opt = np.asarray(opt_poses)[:K]
        if not np.isfinite(opt).all():
            return opt  # caller decides; keyframe poses stay untouched
        for k, kf in enumerate(self._keyframes):
            kf.pose = opt[k]
        return opt

    def build_map(self, voxel_size: float = 0.05, capacity: int = 1 << 18):
        """World model from (optimized) keyframe poses + clouds."""
        from realsensetracker_tpu.tracking import accumulator as acc_mod

        self.flush_pending()
        acc = acc_mod.init_map(capacity)
        for kf in self._keyframes:
            acc = acc_mod.add_cloud(
                acc, jnp.asarray(kf.pose, jnp.float32), kf.cloud, voxel_size
            )
        return acc

    @property
    def world_map(self):
        """Sparse voxel world map (masked Cloud) at the CURRENT keyframe
        poses -- call after optimize() for the loop-consistent model."""
        if not self._keyframes:
            return None
        return self.build_map().extract_cloud()

    def build_dense(self, voxel_size: float = 0.04, resolution: int = 128,
                    margin: float = 0.3):
        """Re-fuse the kept keyframe depths into a TSDF volume at the
        CURRENT (post-optimization) keyframe poses.

        This is the offline-reconstruction step a live frame-to-model
        volume cannot have: its fusion happened at drifted odometry poses
        and is never corrected, while this one integrates every keyframe
        at its loop-closed pose. The volume is AUTO-SIZED: origin centers
        the world-frame bounding box of the keyframe clouds (+ margin),
        and the voxel edge grows above ``voxel_size`` if needed so the
        fixed ``resolution``^3 grid covers the whole box (resolution must
        stay static -- it shapes the XLA program). Returns
        (TsdfVolume, TsdfConfig); requires SlamConfig.keep_depths.
        """
        from realsensetracker_tpu.mapping import tsdf as tsdf_mod

        self.flush_pending()
        if not self._keyframes:
            return None
        if any(kf.depth is None for kf in self._keyframes):
            raise ValueError(
                "dense re-fusion needs the keyframe depth frames: "
                "construct the tracker with SlamConfig(keep_depths=True)"
            )
        mins, maxs = [], []
        for kf in self._keyframes:
            pts = np.asarray(kf.cloud.points)[np.asarray(kf.cloud.mask)]
            if not len(pts):
                continue
            pose = kf.pose.astype(np.float64)
            w = pts.astype(np.float64) @ pose[:3, :3].T + pose[:3, 3]
            mins.append(w.min(axis=0))
            maxs.append(w.max(axis=0))
        if not mins:
            return None
        lo = np.min(mins, axis=0) - margin
        hi = np.max(maxs, axis=0) + margin
        vs = max(float(voxel_size), float((hi - lo).max()) / resolution)
        center = (lo + hi) / 2
        half = resolution * vs / 2
        cfg = tsdf_mod.TsdfConfig(
            resolution=resolution,
            voxel_size=vs,
            origin=tuple(float(c - half) for c in center),
            trunc=max(3.0 * vs, 0.1),
        )
        vol = tsdf_mod.init_volume(cfg)
        for kf in self._keyframes:
            vol = tsdf_mod.integrate(
                vol, jnp.asarray(kf.depth), jnp.asarray(kf.pose, jnp.float32),
                self.config.intrinsics, cfg,
            )
        return vol, cfg

    def world_mesh(self, capacity: int = 131072, voxel_size: float = 0.04,
                   resolution: int = 128, margin: float = 0.3):
        """Loop-consistent dense surface as a TriangleMesh (build_dense +
        marching tetrahedra); None without keyframes, raises without
        keep_depths."""
        from realsensetracker_tpu.mapping.mesh import extract_mesh

        out = self.build_dense(
            voxel_size=voxel_size, resolution=resolution, margin=margin
        )
        if out is None:
            return None
        vol, cfg = out
        return extract_mesh(vol, cfg, capacity)
