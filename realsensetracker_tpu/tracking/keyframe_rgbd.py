"""Frame-to-keyframe RGB-D tracking (joint geometry + photometry VO).

The colored counterpart of tracking/keyframe.py: every frame registers
against a held keyframe with the combined point-to-plane + photometric
objective (align/rgbd.py), promoting the current frame to keyframe on
motion/overlap thresholds, with the reference's failure-holds-pose
semantics (rs_replay_app.cpp:266-273). This is the VO the SLAM layer uses
when a color stream exists: on geometry-degenerate stretches (flat walls,
the seed-11 synthetic scene's sliding ambiguity) the photometric
term pins the in-plane motion that point-to-plane leaves unobservable.

Same single-dispatch streaming shape as the depth tracker: one jitted
program per tracked frame returning the device-resident target (kept for
possible keyframe promotion) plus one packed 25-float stats vector.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from realsensetracker_tpu.align import rgbd as rgbd_mod
from realsensetracker_tpu.geometry import camera, se3
from realsensetracker_tpu.tracking.keyframe import KeyframeResult
from realsensetracker_tpu.tracking.trajectory import Trajectory


@partial(jax.jit, static_argnames=("intr", "cfg"))
def _fused_rgbd_track_step(depth, gray, kf_levels, kf_grays, kf_pose, pose,
                           *, intr, cfg):
    """One whole RGB-D tracked frame as a single XLA program.

    Builds the frame's target (plane-table levels + intensity pyramid,
    kept on device for possible keyframe promotion), samples the source,
    warm-starts from the last pose relative to the keyframe, runs the
    coarse-to-fine joint alignment, and packs the scalars the host needs:
    [rmse, inlier_fraction, finite_ok, twist(6), new_pose(16)]."""
    levels, grays, intrs = rgbd_mod.build_rgbd_target(depth, gray, intr, cfg)
    src_samples = rgbd_mod.sample_rgbd_source(depth, gray, intrs, cfg)
    init = se3.compose(se3.inverse(kf_pose), pose)
    out = rgbd_mod.rgbd_icp_sampled(
        src_samples, kf_levels, kf_grays, intrs, init_transform=init, cfg=cfg
    )
    new_pose = se3.accumulate(kf_pose, out.transform)
    tw = se3.log(out.transform)
    ok = jnp.all(jnp.isfinite(out.transform))
    f32 = jnp.float32
    stats = jnp.concatenate([
        jnp.stack([
            out.rmse.astype(f32),
            out.inlier_fraction.astype(f32),
            ok.astype(f32),
        ]),
        tw.astype(f32),
        new_pose.reshape(-1).astype(f32),
    ])
    return levels, grays, new_pose, stats


@partial(jax.jit, static_argnames=("intr", "cfg", "truncate"))
def _fused_rgbd_track_window(depths, grays_in, kf_levels, kf_grays, kf_pose,
                             pose, streak0, fails0, thresholds, max_fails,
                             row_valid=None, *, intr, cfg, truncate=True):
    """A window of RGB-D tracked frames as one XLA program.

    The colored counterpart of keyframe.py _fused_track_window: lax.scan
    of the joint geometric+photometric track step, carrying the keyframe
    target (plane-table levels + intensity pyramid) on device and
    replicating the promotion/failure logic with where-selects. Returns
    only the per-frame (W, 30) stats matrix -- same row layout as the
    depth-only window scan. ``truncate`` modes and ``row_valid`` padding
    semantics match keyframe.py _fused_track_window exactly: True
    latches the carry at the first keyframe event, "failures" latches
    only at recovery re-seeds (promotions track through in-scan), False
    never latches; invalid rows freeze the carry in every mode."""
    f32, i32 = jnp.float32, jnp.int32
    if row_valid is None:
        row_valid = jnp.ones((depths.shape[0],), bool)

    def body(carry, xs):
        depth, gray, valid = xs
        kf_lv, kf_gr, kf_p, p, streak, fails, done = carry
        dead = done | ~valid
        levels, grs, intrs = rgbd_mod.build_rgbd_target(depth, gray, intr, cfg)
        levels, grs = tuple(levels), tuple(grs)
        src_samples = rgbd_mod.sample_rgbd_source(depth, gray, intrs, cfg)
        init = se3.compose(se3.inverse(kf_p), p)
        out = rgbd_mod.rgbd_icp_sampled(
            src_samples, kf_lv, kf_gr, intrs, init_transform=init, cfg=cfg
        )
        new_pose = se3.accumulate(kf_p, out.transform)
        tw = se3.log(out.transform).astype(f32)
        ok = jnp.all(jnp.isfinite(out.transform))
        inlier = out.inlier_fraction.astype(f32)
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
        sel = lambda a, b: jnp.where(event_now, a, b)
        kf_lv1 = jax.tree_util.tree_map(sel, levels, kf_lv)
        kf_gr1 = jax.tree_util.tree_map(sel, grs, kf_gr)
        streak2 = jnp.where(dead, streak, jnp.where(reseed, i32(0), streak1))
        fails2 = jnp.where(dead, fails, jnp.where(is_new_kf, i32(0), fails1))
        stats = jnp.concatenate([
            jnp.stack([out.rmse.astype(f32), inlier, ok.astype(f32)]),
            tw,
            p1.reshape(-1),
            jnp.stack([
                success.astype(f32),
                is_new_kf.astype(f32),
                fails1.astype(f32),
                streak2.astype(f32),
                fails2.astype(f32),
            ]),
        ])
        if truncate == "failures":
            done1 = done | (is_new_kf & ~success)
        elif truncate:
            done1 = done | is_new_kf
        else:
            done1 = done
        return (kf_lv1, kf_gr1, kf_p1, p1, streak2, fails2, done1), stats

    carry0 = (kf_levels, kf_grays, kf_pose, pose,
              jnp.asarray(streak0, i32), jnp.asarray(fails0, i32),
              jnp.asarray(False))
    (kf_lv, kf_gr, kf_p, p, _, _, _), stats = jax.lax.scan(
        body, carry0, (depths, grays_in, row_valid)
    )
    return kf_lv, kf_gr, kf_p, p, stats


@dataclass
class RgbdKeyframeTracker:
    """Drop-in VO for the SLAM layer when color exists: same interface as
    KeyframeTracker (process -> KeyframeResult, relocalize_to,
    apply_world_correction, last_span_failures) with (depth, gray) input."""

    intr: camera.Intrinsics
    cfg: rgbd_mod.RgbdIcpConfig = rgbd_mod.RgbdIcpConfig()
    min_inlier_fraction: float = 0.2
    max_translation: float = 0.15  # meters
    max_rotation: float = 0.15  # radians
    min_overlap: float = 0.6
    max_consecutive_failures: int = 5

    _fail_streak: int = 0
    _fails_since_kf: int = 0
    last_span_failures: int = 0
    _last_target: object = field(default=None, repr=False)  # (levels, grays)
    # Windowed mode keeps the last frame's (depth, gray) instead of its
    # target; _last_target rebuilds lazily if relocalize_to needs it.
    _last_frame: object = field(default=None, repr=False)
    # Device-cached window-scan constants (see tracking/keyframe.py).
    _thresholds_dev: object = field(default=None, repr=False)
    _max_fails_dev: object = field(default=None, repr=False)
    _kf_target: object = field(default=None, repr=False)
    _kf_pose: object = field(default=None, repr=False)
    _pose: object = field(default=None, repr=False)
    _pose_np: object = field(default=None, repr=False)
    _index: int = 0
    trajectory: Trajectory = field(default_factory=Trajectory)

    def __post_init__(self):
        # Resolution-aware schedule (see KeyframeTracker.__post_init__).
        from realsensetracker_tpu.align import projective

        self.cfg = projective.fit_levels(
            self.cfg, int(self.intr.height), int(self.intr.width)
        )

    @property
    def pose(self):
        return self._pose_np

    def process(self, depth, gray, timestamp: float | None = None) -> KeyframeResult:
        depth = jnp.asarray(depth, jnp.float32)
        gray = jnp.asarray(gray, jnp.float32)
        if timestamp is None:
            timestamp = float(self._index)

        if self._kf_target is None:
            levels, grays, _ = rgbd_mod.build_rgbd_target(
                depth, gray, self.intr, self.cfg
            )
            self._pose = se3.identity()
            self._pose_np = np.eye(4, dtype=np.float32)
            self._kf_pose = self._pose
            self._kf_target = (tuple(levels), tuple(grays))
            self._last_target = self._kf_target
            self.trajectory.append(timestamp, self._pose_np)
            res = KeyframeResult(self._pose_np, True, True, 0.0, 1.0, self._index)
            self._index += 1
            return res

        kf_levels, kf_grays = self._kf_target
        levels, grays, new_pose_dev, stats = _fused_rgbd_track_step(
            depth, gray, kf_levels, kf_grays, self._kf_pose, self._pose,
            intr=self.intr, cfg=self.cfg,
        )
        self._last_target = (levels, grays)
        s = np.asarray(stats)  # the frame's ONE host transfer
        rmse, inlier, finite_ok = float(s[0]), float(s[1]), bool(s[2] > 0.5)
        tw = s[3:9]
        new_pose_np = s[9:25].reshape(4, 4)

        success = finite_ok and inlier >= self.min_inlier_fraction
        is_new_kf = False
        if success:
            self._fail_streak = 0
            self._pose = new_pose_dev
            self._pose_np = new_pose_np
            if (
                np.linalg.norm(tw[:3]) > self.max_translation
                or np.linalg.norm(tw[3:]) > self.max_rotation
                or inlier < self.min_overlap
            ):
                self._kf_target = (levels, grays)
                self._kf_pose = self._pose
                is_new_kf = True
        else:
            self._fail_streak += 1
            self._fails_since_kf += 1
            if self._fail_streak >= self.max_consecutive_failures:
                self._fail_streak = 0
                self._kf_target = (levels, grays)
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

    def process_window(self, depths, grays, timestamps=None,
                       pad_to: int | None = None,
                       truncate_at_events: bool | str = True,
                       ) -> list[KeyframeResult]:
        """Process up to len(depths) RGB-D frames in ONE device dispatch.

        Same contract as KeyframeTracker.process_window, including the
        truncate modes: True consumes up to and INCLUDING the first
        keyframe event (a shorter return means the caller should
        re-submit the unconsumed tail); "failures" consumes promotions
        in-scan and truncates only at recovery re-seeds (the SLAM
        deferred-window mode); False always consumes the whole window.
        pad_to fixes the compiled window shape (padded rows are inert)."""
        if timestamps is None:
            timestamps = [None] * len(depths)
        if self._kf_target is None:
            return [self.process(depths[0], grays[0], timestamps[0])]
        kf_levels, kf_grays = self._kf_target
        n_real = len(depths)

        def stacked(frames):
            s = np.stack([np.asarray(f) for f in frames])
            if pad_to is not None and pad_to > len(frames):
                s = np.concatenate(
                    [s, np.repeat(s[-1:], pad_to - len(frames), axis=0)]
                )
            return jnp.asarray(s, jnp.float32)

        n_rows = max(pad_to or 0, n_real)
        valid = np.arange(n_rows) < n_real
        if self._thresholds_dev is None:
            self._thresholds_dev = jnp.asarray([
                self.min_inlier_fraction, self.max_translation,
                self.max_rotation, self.min_overlap,
            ], jnp.float32)
            self._max_fails_dev = jnp.int32(self.max_consecutive_failures)
        kf_lv_dev, kf_gr_dev, kf_pose_dev, pose_dev, stats = \
            _fused_rgbd_track_window(
                stacked(depths),
                stacked(grays),
                kf_levels, kf_grays, self._kf_pose, self._pose,
                self._fail_streak, self._fails_since_kf,
                self._thresholds_dev, self._max_fails_dev,
                jnp.asarray(valid),
                intr=self.intr, cfg=self.cfg,
                truncate=truncate_at_events,
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
        self._last_frame = (depths[last], grays[last])
        self._last_target = None  # rebuilt lazily from _last_frame if needed
        if event:
            # The carry holds the keyframe state at the truncation point
            # (latched modes) or after the LAST event (multi-event mode),
            # device-resident -- no target rebuild dispatch either way.
            self._pose = pose_dev
            self._kf_target = (kf_lv_dev, kf_gr_dev)
            self._kf_pose = kf_pose_dev
            self.last_span_failures = int(s[last_event, 27])
            if hard_stop:
                self._last_target = self._kf_target
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
        """See KeyframeTracker.relocalize_to."""
        self._pose = jnp.asarray(pose, jnp.float32)
        self._pose_np = np.asarray(pose, np.float32)
        self._kf_pose = self._pose
        if self._last_target is None and self._last_frame is not None:
            d, g = self._last_frame
            levels, grs, _ = rgbd_mod.build_rgbd_target(
                jnp.asarray(d, jnp.float32), jnp.asarray(g, jnp.float32),
                self.intr, self.cfg,
            )
            self._last_target = (tuple(levels), tuple(grs))
        self._kf_target = self._last_target
        self._fail_streak = 0
        self._fails_since_kf = 0
        if self.trajectory.poses:
            self.trajectory.poses[-1] = np.asarray(pose, np.float64)

    def apply_world_correction(self, delta) -> None:
        """See KeyframeTracker.apply_world_correction."""
        d = jnp.asarray(delta, jnp.float32)
        self._pose = se3.orthonormalize(se3.compose(d, self._pose))
        self._kf_pose = se3.orthonormalize(se3.compose(d, self._kf_pose))
        self._pose_np = np.asarray(self._pose)
        if self.trajectory.poses:
            self.trajectory.poses[-1] = np.asarray(self._pose_np, np.float64)
