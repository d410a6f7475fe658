"""Frame-to-keyframe tracking (BASELINE config 3).

The reference sketches frame-to-model registration in a disabled branch
(rs_replay_app.cpp:274-287); the standard production form is
frame-to-KEYFRAME: register every frame against a held keyframe (less drift
than frame-to-frame), promoting the current frame to keyframe when motion or
overlap crosses a threshold. Same failure semantics as the replay loop:
a failed registration keeps both the pose and the keyframe.

Streaming shape: every eager device op and every host transfer has a
fixed cost, so an op-by-op process() -- pyramid, inverse, compose, icp,
accumulate, log, plus five scalar materializations -- pays it a dozen
times per frame. The whole per-frame step is therefore ONE jitted program
(_fused_track_step) returning the device-resident pyramid (kept on device
for possible keyframe promotion) plus a single packed 25-float stats
vector, so a tracked frame costs one dispatch + one tiny transfer.
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
from realsensetracker_tpu.ops.pyramid import depth_to_meters as _depth_meters
from realsensetracker_tpu.tracking.trajectory import Trajectory


class KeyframeResult(NamedTuple):
    pose: np.ndarray  # world_from_camera (host array; device copy stays on chip)
    success: bool
    is_new_keyframe: bool
    rmse: float
    inlier_fraction: float
    frame_index: int
    # Tracking failures in the keyframe span ENDING at this event (0 on
    # non-event frames). The SLAM layer discounts the odometry edge into
    # the new keyframe by it; carrying it on the result (rather than only
    # tracker.last_span_failures) lets multi-event windows report the
    # correct span for EACH promotion in the window.
    span_failures: int = 0


@partial(jax.jit, static_argnames=("intr", "cfg", "depth_scale"))
def _fused_track_step(depth, kf_levels, kf_pose, pose, *, intr, cfg,
                      depth_scale=1.0):
    """One whole tracked frame as a single XLA program.

    Builds the frame pyramid, warm-starts from the last pose relative to
    the keyframe, runs coarse-to-fine projective ICP, accumulates the pose
    (SE(3)-projected), and packs every scalar the host needs into one
    vector: [rmse, inlier_fraction, finite_ok, twist(6), new_pose(16)].
    Returns (levels, new_pose_device, stats (25,))."""
    from realsensetracker_tpu.ops.pyramid import build_pyramid

    levels, intrs = build_pyramid(
        _depth_meters(depth, depth_scale), intr, len(cfg.iters),
        cfg.min_depth, cfg.max_depth,
    )
    init = se3.compose(se3.inverse(kf_pose), pose)
    icp = projective.projective_icp(
        levels, kf_levels, tuple(intrs), init_transform=init, cfg=cfg
    )
    new_pose = se3.accumulate(kf_pose, icp.transform)
    tw = se3.log(icp.transform)
    ok = jnp.all(jnp.isfinite(icp.transform))
    f32 = jnp.float32
    stats = jnp.concatenate([
        jnp.stack([
            icp.rmse.astype(f32),
            icp.inlier_fraction.astype(f32),
            ok.astype(f32),
        ]),
        tw.astype(f32),
        new_pose.reshape(-1).astype(f32),
    ])
    return tuple(levels), new_pose, stats


@partial(jax.jit, static_argnames=("intr", "cfg", "truncate", "depth_scale"))
def _fused_track_window(depths, kf_levels, kf_pose, pose, streak0, fails0,
                        thresholds, max_fails, row_valid=None, *, intr, cfg,
                        truncate=True, depth_scale=1.0):
    """A whole WINDOW of tracked frames as a single XLA program.

    lax.scan of the fused track step over W depth frames, carrying the
    keyframe pyramid/pose on device and replicating the host promotion
    logic (motion/overlap thresholds, failure streaks, recovery re-seed)
    with `where` selects. Scanning W frames amortizes the per-dispatch
    host cost over the window. Only the per-frame stats come back (one
    (W, 30) transfer) -- the host truncates the window at the first
    keyframe event and adopts the LATCHED device-resident carry as the new
    state, so the pyramids never leave the device (see the latch note
    below).

    thresholds: (4,) f32 [min_inlier_fraction, max_translation,
    max_rotation, min_overlap]; max_fails: int32 scalar.

    Per-frame stats row (30,) f32:
    [0] rmse  [1] inlier_fraction  [2] finite_ok  [3:9] twist
    [9:25] pose after the frame (held on failure)  [25] success
    [26] is_new_keyframe  [27] span failures at the event (value BEFORE
    the keyframe reset)  [28] fail streak after  [29] fails since
    keyframe after.

    With ``truncate=True`` the carry LATCHES at the first keyframe event
    (`done` freezes all updates), so the returned (kf_levels, kf_pose,
    pose) are exactly the state at the truncation point -- the host
    adopts them directly (device-resident; the event frame's pyramid
    never needs a rebuild dispatch). Rows after the first event are
    computed against the frozen state and discarded by the host.

    With ``truncate=False`` keyframe events do NOT latch: every event
    promotes in-scan (the carry already re-seeds the keyframe pyramid
    from the event row's levels) and the scan tracks straight through
    any number of events -- per-frame-identical for a plain tracker,
    since the device replicates the full host promotion/failure logic.
    Hosts that must ACT between frames (the SLAM layer's loop closure /
    relocalization) need truncate=True. Measured motivation: with events
    every ~6 frames, truncation wasted ~27% of scan rows and paid 19
    dispatches per 56 frames at W=4.

    With ``truncate="failures"`` only recovery re-seeds latch: successful
    promotions track straight through in-scan, while a failure-streak
    re-seed freezes the carry so the host can attempt relocalization at
    that frame and re-submit the tail. This is the SLAM window mode
    (SlamConfig.window_defer_events): the host only needs to ACT between
    frames at failures; promotion bookkeeping (loop closure, graph
    edges) reads the per-row stats after the dispatch.

    ``row_valid`` ((W,) bool, optional) marks real rows; invalid rows
    freeze the carry exactly like the latch, which is what makes PADDED
    windows inert in both modes (with truncate=True padding was
    previously safe only because a real event preceded it).
    """
    from realsensetracker_tpu.ops.pyramid import build_pyramid

    f32, i32 = jnp.float32, jnp.int32
    if row_valid is None:
        row_valid = jnp.ones((depths.shape[0],), bool)

    def body(carry, xs):
        depth, valid = xs
        kf_lv, kf_p, p, streak, fails, done = carry
        dead = done | ~valid
        levels, intrs = build_pyramid(
            _depth_meters(depth, depth_scale), intr, len(cfg.iters),
            cfg.min_depth, cfg.max_depth,
        )
        levels = tuple(levels)
        init = se3.compose(se3.inverse(kf_p), p)
        icp = projective.projective_icp(
            levels, kf_lv, tuple(intrs), init_transform=init, cfg=cfg
        )
        new_pose = se3.accumulate(kf_p, icp.transform)
        tw = se3.log(icp.transform).astype(f32)
        ok = jnp.all(jnp.isfinite(icp.transform))
        inlier = icp.inlier_fraction.astype(f32)
        success = ok & (inlier >= thresholds[0])
        promote = success & (
            (jnp.linalg.norm(tw[:3]) > thresholds[1])
            | (jnp.linalg.norm(tw[3:]) > thresholds[2])
            | (inlier < thresholds[3])
        )
        streak1 = jnp.where(success, i32(0), streak + i32(1))
        fails1 = jnp.where(success, fails, fails + i32(1))
        reseed = (~success) & (streak1 >= max_fails)
        is_new_kf = promote | reseed
        event_now = is_new_kf & ~dead
        p1 = jnp.where(success & ~dead, new_pose, p).astype(f32)
        kf_p1 = jnp.where(event_now, p1, kf_p).astype(f32)
        kf_lv1 = jax.tree_util.tree_map(
            lambda a, b: jnp.where(event_now, a, b), levels, kf_lv
        )
        streak2 = jnp.where(dead, streak, jnp.where(reseed, i32(0), streak1))
        fails2 = jnp.where(dead, fails, jnp.where(is_new_kf, i32(0), fails1))
        stats = jnp.concatenate([
            jnp.stack([icp.rmse.astype(f32), inlier, ok.astype(f32)]),
            tw,
            p1.reshape(-1),
            jnp.stack([
                success.astype(f32),
                is_new_kf.astype(f32),
                fails1.astype(f32),  # span failures at a (potential) event
                streak2.astype(f32),
                fails2.astype(f32),
            ]),
        ])
        if truncate == "failures":
            # Latch only at recovery re-seeds: promotions track straight
            # through in-scan, but a failure-streak re-seed stops the
            # window so the host (SLAM relocalization) can act on it.
            done1 = done | (is_new_kf & ~success)
        elif truncate:
            done1 = done | is_new_kf
        else:
            done1 = done
        return (kf_lv1, kf_p1, p1, streak2, fails2, done1), stats

    carry0 = (kf_levels, kf_pose, pose,
              jnp.asarray(streak0, i32), jnp.asarray(fails0, i32),
              jnp.asarray(False))
    (kf_lv, kf_p, p, _, _, _), stats = jax.lax.scan(
        body, carry0, (depths, row_valid)
    )
    return kf_lv, kf_p, p, stats


@dataclass
class KeyframeTracker:
    # Raw integer (u16) frames upload verbatim and convert to meters ON
    # DEVICE at self.depth_scale (half the f32 upload bytes) -- the
    # protocol attribute the api facade / HTTP service probe before
    # passing raw frames through (api/service.py _ingest_depth).
    accepts_raw_depth = True

    intr: camera.Intrinsics
    cfg: projective.ProjectiveIcpConfig = projective.ProjectiveIcpConfig()
    min_inlier_fraction: float = 0.2
    # Promote keyframe when relative motion exceeds these bounds:
    max_translation: float = 0.15  # meters
    max_rotation: float = 0.15  # radians
    min_overlap: float = 0.6  # inlier fraction below this forces a keyframe
    # Lost-tracking recovery: after this many consecutive failures the
    # CURRENT frame becomes the keyframe (pose held). Without this a
    # transient degeneracy (e.g. a featureless-wall stretch) leaves the
    # tracker registering against an ever-staler keyframe forever; with
    # it, tracking resumes as soon as content returns and the SLAM
    # layer's loop closure can re-anchor the accumulated drift.
    max_consecutive_failures: int = 5
    # Meters per raw unit for INTEGER depth frames (RealSense Z16 depth
    # units default to 1 mm; TUM 16-bit PNGs use 1/5000). Integer frames
    # upload as uint16 -- half the bytes of f32 -- and convert on device
    # inside the fused program. Float frames are taken as meters as-is.
    depth_scale: float = 1e-3

    _fail_streak: int = 0
    # Failed frames since the previous keyframe, snapshotted into
    # last_span_failures at every keyframe event: the SLAM layer uses it
    # to DOWN-WEIGHT odometry edges spanning tracking loss (the held pose
    # makes those edges miss real motion entirely).
    _fails_since_kf: int = 0
    last_span_failures: int = 0
    _last_levels: object = field(default=None, repr=False)
    # Windowed mode keeps the last frame's depth instead of its pyramid
    # (the scan never ships pyramids to the host); _last_levels rebuilds
    # lazily from it if relocalize_to needs the frame as a keyframe.
    _last_depth: object = field(default=None, repr=False)
    # Device-cached window-scan constants (values never change for a
    # tracker's lifetime; re-uploading them per window would add host
    # transfers to the one scan dispatch the design amortizes toward).
    _thresholds_dev: object = field(default=None, repr=False)
    _max_fails_dev: object = field(default=None, repr=False)
    _kf_levels: object = field(default=None, repr=False)
    _kf_pose: object = field(default=None, repr=False)  # world_from_keyframe
    _pose: object = field(default=None, repr=False)  # device copy
    _pose_np: object = field(default=None, repr=False)  # host mirror
    _index: int = 0
    trajectory: Trajectory = field(default_factory=Trajectory)

    def __post_init__(self):
        # Resolution-aware schedule: drop coarse levels that would fall
        # below ~24 px at this resolution (no-op at 640x480). Normalizing
        # the STORED cfg keeps the seed pyramid, the fused step/window
        # programs and relocalization all on the same level count.
        self.cfg = projective.fit_levels(
            self.cfg, int(self.intr.height), int(self.intr.width)
        )

    @property
    def pose(self):
        return self._pose_np

    def process(self, depth, timestamp: float | None = None) -> KeyframeResult:
        from realsensetracker_tpu.ops.pyramid import build_pyramid

        depth = jnp.asarray(depth)
        if not jnp.issubdtype(depth.dtype, jnp.integer):
            depth = depth.astype(jnp.float32)  # pin: a f64 input would
            # otherwise compile a second program;
            # integer (u16) frames stay raw and convert in-program
        if timestamp is None:
            timestamp = float(self._index)

        if self._kf_levels is None:
            levels, _ = build_pyramid(
                _depth_meters(depth, self.depth_scale), self.intr,
                len(self.cfg.iters), self.cfg.min_depth, self.cfg.max_depth,
            )
            self._pose = se3.identity()
            self._pose_np = np.eye(4, dtype=np.float32)
            self._kf_pose = self._pose
            self._kf_levels = tuple(levels)
            self._last_levels = self._kf_levels
            self.trajectory.append(timestamp, self._pose_np)
            res = KeyframeResult(self._pose_np, True, True, 0.0, 1.0, self._index)
            self._index += 1
            return res

        levels, new_pose_dev, stats = _fused_track_step(
            depth, self._kf_levels, self._kf_pose, self._pose,
            intr=self.intr, cfg=self.cfg, depth_scale=self.depth_scale,
        )
        self._last_levels = levels  # kept for a possible external re-seed
        s = np.asarray(stats)  # the frame's ONE host transfer
        rmse, inlier, finite_ok = float(s[0]), float(s[1]), bool(s[2] > 0.5)
        tw = s[3:9]
        new_pose_np = s[9:25].reshape(4, 4)

        success = finite_ok and inlier >= self.min_inlier_fraction
        is_new_kf = False
        if success:
            self._fail_streak = 0
            self._pose = new_pose_dev  # stays on device for the warm start
            self._pose_np = new_pose_np
            if (
                np.linalg.norm(tw[:3]) > self.max_translation
                or np.linalg.norm(tw[3:]) > self.max_rotation
                or inlier < self.min_overlap
            ):
                self._kf_levels = levels
                self._kf_pose = self._pose
                is_new_kf = True
        else:
            self._fail_streak += 1
            self._fails_since_kf += 1
            if self._fail_streak >= self.max_consecutive_failures:
                # Recovery re-seed: pose held, current frame becomes the
                # reference so tracking can resume.
                self._fail_streak = 0
                self._kf_levels = levels
                self._kf_pose = self._pose
                is_new_kf = True
        if is_new_kf:
            self.last_span_failures = self._fails_since_kf
            self._fails_since_kf = 0
        self.trajectory.append(timestamp, self._pose_np)
        res = KeyframeResult(
            pose=self._pose_np,
            success=success,
            is_new_keyframe=is_new_kf,
            rmse=rmse,
            inlier_fraction=inlier,
            frame_index=self._index,
            span_failures=self.last_span_failures if is_new_kf else 0,
        )
        self._index += 1
        return res

    def process_window(self, depths, timestamps=None,
                       pad_to: int | None = None,
                       truncate_at_events: bool | str = True,
                       ) -> list[KeyframeResult]:
        """Process up to len(depths) frames in ONE device dispatch.

        With ``truncate_at_events=True`` (default): consumes frames up to
        and INCLUDING the first keyframe event (promotion or recovery
        re-seed), or the whole window if none occurs, and returns their
        KeyframeResults -- fewer results than depths means the caller
        should re-submit the unconsumed tail (the event may change
        tracking state in ways only the host decides, e.g. the SLAM
        layer's relocalization).

        With ``truncate_at_events=False``: ALWAYS consumes the whole
        window -- keyframe promotions happen entirely in-scan (any number
        per window) and the final carry is adopted device-resident.
        Exactly 1/W dispatches per frame; per-frame-identical results.
        Use this whenever nothing needs to run between frames (plain
        replay/VO); the SLAM layer needs a truncating mode.

        With ``truncate_at_events="failures"``: promotions are consumed
        in-scan like False, but the window truncates at the first
        recovery re-seed (failure streak), where the host must act
        (SLAM relocalization). Event rows carry their own span_failures,
        so deferred per-promotion bookkeeping stays exact.

        Per-frame semantics are replicated exactly on device
        (_fused_track_window); a window costs one scan dispatch + one
        (W, 30) stats transfer.

        pad_to: pad the scan to this fixed frame count (last frame
        repeated; padded rows carry row_valid=False and freeze the scan
        carry, so they are inert in BOTH modes) so every window --
        including post-event tails -- reuses ONE compiled program.
        Without it each distinct window length is a separate compile.
        """
        if timestamps is None:
            timestamps = [None] * len(depths)
        if self._kf_levels is None:  # bootstrap: first frame seeds the keyframe
            return [self.process(depths[0], timestamps[0])]
        arrs = [np.asarray(d) for d in depths]
        kinds = {bool(np.issubdtype(a.dtype, np.integer)) for a in arrs}
        if len(kinds) > 1:
            # Mixed raw-integer / float-meters windows: np.stack would
            # silently promote the raw frames to float COUNTS and the
            # scan would read them as meters (5000x off). Convert the
            # integer frames to meters here instead.
            from realsensetracker_tpu.data.depth_units import to_meters_np

            arrs = [to_meters_np(a, self.depth_scale) for a in arrs]
        stack = np.stack(arrs)
        if not np.issubdtype(stack.dtype, np.integer):
            stack = stack.astype(np.float32)
        # Integer (u16) windows upload raw -- half the f32 bytes, and the
        # upload rides the timed dispatch; the scan body converts to
        # meters on device.
        n_real = len(depths)
        if pad_to is not None and pad_to > n_real:
            stack = np.concatenate(
                [stack, np.repeat(stack[-1:], pad_to - n_real, axis=0)]
            )
        valid = np.arange(stack.shape[0]) < n_real
        if self._thresholds_dev is None:
            self._thresholds_dev = jnp.asarray([
                self.min_inlier_fraction, self.max_translation,
                self.max_rotation, self.min_overlap,
            ], jnp.float32)
            self._max_fails_dev = jnp.int32(self.max_consecutive_failures)
        kf_lv_dev, kf_pose_dev, pose_dev, stats = _fused_track_window(
            jnp.asarray(stack),
            self._kf_levels, self._kf_pose, self._pose,
            self._fail_streak, self._fails_since_kf,
            self._thresholds_dev, self._max_fails_dev,
            jnp.asarray(valid),
            intr=self.intr, cfg=self.cfg, truncate=truncate_at_events,
            depth_scale=self.depth_scale,
        )
        s = np.asarray(stats)  # the window's ONE host transfer
        results: list[KeyframeResult] = []
        consumed = 0
        event = False
        hard_stop = False  # the scan carry latched at the consumed tail
        last_event = -1
        for i in range(n_real):
            ts = timestamps[i] if timestamps[i] is not None else float(self._index)
            pose_np = s[i, 9:25].reshape(4, 4).astype(np.float32)
            success = s[i, 25] > 0.5
            is_new_kf = s[i, 26] > 0.5
            self._pose_np = pose_np
            self.trajectory.append(ts, pose_np)
            results.append(KeyframeResult(
                pose=pose_np,
                success=bool(success),
                is_new_keyframe=bool(is_new_kf),
                rmse=float(s[i, 0]),
                inlier_fraction=float(s[i, 1]),
                frame_index=self._index,
                span_failures=int(s[i, 27]) if is_new_kf else 0,
            ))
            self._index += 1
            consumed = i + 1
            if is_new_kf:
                event = True
                last_event = i
                if truncate_at_events is True or (
                    truncate_at_events == "failures" and not success
                ):
                    hard_stop = True
                    break
        last = consumed - 1
        self._last_depth = depths[last]
        self._last_levels = None  # rebuilt lazily from _last_depth if needed
        if event:
            # The carry holds the keyframe state at the truncation point
            # (latched modes) or after the LAST event (multi-event mode),
            # device-resident -- no pyramid rebuild either way.
            self._pose = pose_dev
            self._kf_levels = kf_lv_dev
            self._kf_pose = kf_pose_dev
            self.last_span_failures = int(s[last_event, 27])
            if hard_stop:
                self._last_levels = kf_lv_dev
                self._fail_streak = 0
                self._fails_since_kf = 0
            else:
                self._fail_streak = int(s[last, 28])
                self._fails_since_kf = int(s[last, 29])
        else:
            self._pose = jnp.asarray(self._pose_np)
            self._fail_streak = int(s[last, 28])
            self._fails_since_kf = int(s[last, 29])
        return results

    def relocalize_to(self, pose) -> None:
        """Override the pose with an externally-computed estimate and
        re-seed the keyframe at the LAST processed frame.

        Used by the SLAM layer's relocalization: when projective ICP falls
        outside its convergence basin (fast rotation bursts), a robust
        global registration (FPFH + GNC-TLS -- the reference's TEASER
        recovery role, rs_align_app.cpp:310-314) recovers the pose and
        hands it back here so local tracking resumes from the corrected
        state instead of holding a stale pose through the burst."""
        from realsensetracker_tpu.ops.pyramid import build_pyramid

        self._pose = jnp.asarray(pose, jnp.float32)
        self._pose_np = np.asarray(pose, np.float32)
        self._kf_pose = self._pose
        if self._last_levels is None and self._last_depth is not None:
            levels, _ = build_pyramid(
                _depth_meters(jnp.asarray(self._last_depth), self.depth_scale),
                self.intr, len(self.cfg.iters),
                self.cfg.min_depth, self.cfg.max_depth,
            )
            self._last_levels = tuple(levels)
        self._kf_levels = self._last_levels
        self._fail_streak = 0
        self._fails_since_kf = 0
        if self.trajectory.poses:
            self.trajectory.poses[-1] = np.asarray(pose, np.float64)

    def apply_world_correction(self, delta) -> None:
        """Left-multiply a world-frame correction into the tracker state.

        Used by online pose-graph optimization (SlamConfig.optimize_every):
        after the graph moves the latest keyframe from P to P', the SLAM
        layer hands delta = P' P^-1 here so subsequent tracking continues
        from the drift-corrected trajectory. Keyframe pyramids live in
        CAMERA coordinates, so only the pose state changes."""
        d = jnp.asarray(delta, jnp.float32)
        self._pose = se3.orthonormalize(se3.compose(d, self._pose))
        self._kf_pose = se3.orthonormalize(se3.compose(d, self._kf_pose))
        self._pose_np = np.asarray(self._pose)
        if self.trajectory.poses:
            self.trajectory.poses[-1] = np.asarray(self._pose_np, np.float64)
