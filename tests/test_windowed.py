"""Windowed (scanned) VO and SLAM: process_window must replicate the
per-frame path's results exactly -- same poses, same success flags, same
keyframe events -- while batching up to W frames per device dispatch
(tracking/keyframe.py _fused_track_window; the scan truncates the window
at every keyframe event so host-side SLAM logic runs unchanged)."""

import jax.numpy as jnp
import numpy as np
import pytest

from realsensetracker_tpu.align import projective
from realsensetracker_tpu.data import synthetic
from realsensetracker_tpu.geometry import camera, se3
from realsensetracker_tpu.tracking.keyframe import KeyframeTracker
from realsensetracker_tpu.tracking.slam import SlamConfig, SlamTracker

INTR = camera.Intrinsics(fx=100.0, fy=100.0, cx=49.5, cy=37.0, width=100, height=75)
CFG = projective.ProjectiveIcpConfig(iters=(4, 4, 5), samples=1024)


def _sequence(n, step=(0.03, 0.0, 0.02, 0.0, 0.025, 0.0), seed=21):
    scene = synthetic.default_scene(seed=seed)
    step = jnp.asarray(step, jnp.float32)
    poses = [se3.identity()]
    for _ in range(n - 1):
        poses.append(se3.compose(poses[-1], se3.exp(step)))
    return [synthetic.render_depth(INTR, T, scene) for T in poses]


def _run_per_frame(tracker, depths):
    return [tracker.process(d, float(i)) for i, d in enumerate(depths)]


def _run_windowed(tracker, depths, window):
    out = []
    i = 0
    while i < len(depths):
        chunk = depths[i : i + window]
        ts = [float(j) for j in range(i, i + len(chunk))]
        if isinstance(tracker, SlamTracker):
            res = tracker.process_window(chunk, ts, window=window)
            out.extend(res)
            i += len(res)
        else:
            res = tracker.process_window(chunk, ts)
            out.extend(res)
            i += len(res)
    return out


def _assert_results_match(a, b):
    assert len(a) == len(b)
    for ra, rb in zip(a, b):
        assert ra.frame_index == rb.frame_index
        assert ra.success == rb.success, ra.frame_index
        assert ra.is_new_keyframe == rb.is_new_keyframe, ra.frame_index
        np.testing.assert_allclose(ra.pose, rb.pose, atol=1e-5)
        assert abs(ra.rmse - rb.rmse) < 1e-5
        assert abs(ra.inlier_fraction - rb.inlier_fraction) < 1e-5


class TestWindowedVo:
    def test_matches_per_frame_with_promotions(self):
        depths = _sequence(9)
        ref = KeyframeTracker(INTR, CFG, max_translation=0.06, max_rotation=0.05)
        win = KeyframeTracker(INTR, CFG, max_translation=0.06, max_rotation=0.05)
        ra = _run_per_frame(ref, depths)
        rb = _run_windowed(win, depths, window=4)
        _assert_results_match(ra, rb)
        # State converges identically: keyframe pose and bookkeeping.
        np.testing.assert_allclose(
            np.asarray(ref._kf_pose), np.asarray(win._kf_pose), atol=1e-5
        )
        assert ref._fail_streak == win._fail_streak
        assert len(ref.trajectory) == len(win.trajectory)
        assert any(r.is_new_keyframe for r in ra[1:])  # promotions exercised

    def test_matches_per_frame_through_failures_and_reseed(self):
        good = _sequence(4, step=(0.01, 0.0, 0.01, 0.0, 0.01, 0.0))
        dead = [jnp.zeros_like(good[0])] * 3  # all-invalid: tracking fails
        tail = [good[-1]] * 2
        depths = good + dead + tail
        kw = dict(max_consecutive_failures=2, max_translation=10.0,
                  max_rotation=10.0)
        ref = KeyframeTracker(INTR, CFG, **kw)
        win = KeyframeTracker(INTR, CFG, **kw)
        ra = _run_per_frame(ref, depths)
        rb = _run_windowed(win, depths, window=4)
        _assert_results_match(ra, rb)
        assert any(not r.success for r in ra)  # failures exercised
        # The recovery re-seed (failure-streak keyframe) fired identically.
        assert any(r.is_new_keyframe and not r.success for r in ra)
        assert ref.last_span_failures == win.last_span_failures

    def test_api_tracker_window(self):
        from realsensetracker_tpu.api import Tracker, TrackerConfig

        depths = _sequence(6)
        cfg = TrackerConfig(intrinsics=INTR, method="keyframe",
                            projective=CFG)
        ref, win = Tracker(cfg), Tracker(cfg)
        ra = _run_per_frame(ref, depths)
        rb = win.process_window(depths, [float(i) for i in range(6)], window=4)
        _assert_results_match(ra, rb)
        try:
            Tracker(TrackerConfig(intrinsics=INTR, method="projective")
                    ).process_window(depths)
        except ValueError:
            pass
        else:
            raise AssertionError("non-keyframe process_window should raise")

    def test_window_larger_than_sequence(self):
        depths = _sequence(3, step=(0.01, 0.0, 0.0, 0.0, 0.0, 0.0))
        ref = KeyframeTracker(INTR, CFG)
        win = KeyframeTracker(INTR, CFG)
        ra = _run_per_frame(ref, depths)
        rb = _run_windowed(win, depths, window=16)
        _assert_results_match(ra, rb)


class TestWindowedSlam:
    def _make(self):
        cfg = SlamConfig(
            intrinsics=INTR,
            icp=CFG,
            loop_min_separation=3,
            loop_similarity=0.8,
            keyframe_cloud_capacity=1024,
        )
        cfg.align.fpfh_max_neighbors = 32
        t = SlamTracker(cfg)
        t._vo.max_translation = 0.05  # dense keyframes on this trajectory
        t._vo.max_rotation = 0.05
        return t

    def test_matches_per_frame_slam(self):
        scene = synthetic.default_scene(seed=21)
        step = jnp.asarray([0.03, 0.0, 0.02, 0.0, 0.025, 0.0], jnp.float32)
        poses = [se3.identity()]
        for i in range(9):
            s = step if i < 5 else -step
            poses.append(se3.compose(poses[-1], se3.exp(s)))
        depths = [synthetic.render_depth(INTR, T, scene) for T in poses]
        ref = self._make()
        win = self._make()
        ra = _run_per_frame(ref, depths)
        rb = _run_windowed(win, depths, window=4)
        _assert_results_match(ra, rb)
        assert win.keyframe_count == ref.keyframe_count
        assert win.num_loop_closures == ref.num_loop_closures
        for pa, pb in zip(ref.trajectory.poses, win.trajectory.poses):
            np.testing.assert_allclose(pa, pb, atol=1e-5)

    def test_cli_window_flag(self, tmp_path, capsys):
        from realsensetracker_tpu.cli import rs_replay
        from realsensetracker_tpu.data import tum as tum_mod

        root = str(tmp_path / "seq")
        tum_mod.synthesize_tum_sequence(root, num_frames=6, seed=3,
                                        width=100, height=75)
        rc = rs_replay.main(["--tum", root, "--method", "slam",
                             "--window", "4", "--ate"])
        out = capsys.readouterr().out
        assert rc == 0
        assert "processed 6 frames" in out
        assert "ATE:" in out
        # --window outside depth-only SLAM is rejected.
        assert rs_replay.main(["--tum", root, "--method", "projective",
                               "--window", "4"]) == 1

    def test_rgb_window_matches_per_frame(self):
        from realsensetracker_tpu.align.rgbd import RgbdIcpConfig

        scene = synthetic.default_scene(seed=13)
        step = jnp.asarray([0.025, 0.0, 0.02, 0.0, 0.02, 0.0], jnp.float32)
        poses = [se3.identity()]
        for _ in range(7):
            poses.append(se3.compose(poses[-1], se3.exp(step)))
        depths, grays = [], []
        for T in poses:
            d, rgb = synthetic.render_rgbd(INTR, T, scene)
            depths.append(d)
            grays.append(synthetic.intensity_from_rgb(rgb))

        def make():
            cfg = SlamConfig(
                intrinsics=INTR, use_rgb=True,
                rgbd=RgbdIcpConfig(iters=(4, 4), samples=768),
                keyframe_cloud_capacity=1024,
            )
            cfg.align.fpfh_max_neighbors = 32
            t = SlamTracker(cfg)
            t._vo.max_translation = 0.05
            t._vo.max_rotation = 0.05
            return t

        ref, win = make(), make()
        ra = [ref.process(d, float(i), gray=g)
              for i, (d, g) in enumerate(zip(depths, grays))]
        rb = []
        i = 0
        while i < len(depths):
            res = win.process_window(
                depths[i:], [float(j) for j in range(i, len(depths))],
                window=4, grays=grays[i:],
            )
            rb.extend(res)
            i += len(res)
        _assert_results_match(ra, rb)
        assert win.keyframe_count == ref.keyframe_count

    def test_rgb_mode_needs_grays(self):
        cfg = SlamConfig(intrinsics=INTR, use_rgb=True)
        t = SlamTracker(cfg)
        try:
            t.process_window([jnp.zeros((75, 100), jnp.float32)])
        except ValueError:
            return
        raise AssertionError("use_rgb process_window without grays should raise")


class TestWindowedTsdf:
    """tracking/tsdf_tracker.py process_window: the lax.scan window must
    be per-frame-identical to sequential process() calls (same traced
    step math; padded tails hold state like failed frames)."""

    def _pair(self, use_color=False):
        from realsensetracker_tpu.align.projective import ProjectiveIcpConfig
        from realsensetracker_tpu.data import synthetic
        from realsensetracker_tpu.geometry import camera
        from realsensetracker_tpu.mapping import tsdf
        from realsensetracker_tpu.tracking.tsdf_tracker import TsdfTracker

        W, H = 80, 60
        intr = camera.Intrinsics(
            fx=64.0, fy=64.0, cx=(W - 1) / 2, cy=(H - 1) / 2,
            width=W, height=H,
        )
        cfg = tsdf.TsdfConfig(
            resolution=64, voxel_size=0.1, origin=(-3.2, -2.4, -0.3),
            trunc=0.3, max_range=5.0,
        )
        icp = ProjectiveIcpConfig(
            iters=(3, 3), inner_iters=2, samples=768, min_samples=192
        )
        mk = lambda: TsdfTracker(  # noqa: E731
            intr, volume=cfg, icp=icp, use_color=use_color
        )
        depths, _ = synthetic.render_trajectory(
            intr, 7, scene=synthetic.default_scene(seed=3), seed=1,
            step_scale=0.01,
        )
        return mk(), mk(), [np.asarray(d) for d in depths]

    def test_matches_per_frame(self):
        a, b, depths = self._pair()
        ra = [a.process(d, float(i)) for i, d in enumerate(depths)]
        # 7 frames, window 3: seed + chunks of 3/3 -> exercises the
        # padded tail (last chunk is a single real frame + 2 pad rows).
        rb = b.process_window(depths, [float(i) for i in range(7)], window=3)
        assert len(rb) == len(ra)
        for x, y in zip(ra, rb):
            assert x.success == y.success
            np.testing.assert_allclose(x.pose, y.pose, atol=1e-5)
            np.testing.assert_allclose(x.relative, y.relative, atol=1e-5)
        np.testing.assert_allclose(
            np.asarray(a._vol.tsdf), np.asarray(b._vol.tsdf), atol=1e-5
        )
        assert len(a.trajectory) == len(b.trajectory)

    def test_color_window_matches_per_frame(self):
        a, b, depths = self._pair(use_color=True)
        colors = [
            np.full(depths[0].shape + (3,), 0.3 + 0.05 * i, np.float32)
            for i in range(len(depths))
        ]
        ra = [
            a.process(d, float(i), color=c)
            for i, (d, c) in enumerate(zip(depths, colors))
        ]
        rb = b.process_window(
            depths, [float(i) for i in range(len(depths))],
            window=4, colors=colors,
        )
        for x, y in zip(ra, rb):
            np.testing.assert_allclose(x.pose, y.pose, atol=1e-5)
        np.testing.assert_allclose(
            np.asarray(a._vol.color), np.asarray(b._vol.color), atol=1e-5
        )

    def test_color_required(self):
        _, b, depths = self._pair(use_color=True)
        with pytest.raises(ValueError, match="color"):
            b.process_window(depths, window=4)

    def test_facade_window(self):
        from realsensetracker_tpu.align.projective import ProjectiveIcpConfig
        from realsensetracker_tpu.api.config import TrackerConfig
        from realsensetracker_tpu.api.tracker import Tracker
        from realsensetracker_tpu.data import synthetic
        from realsensetracker_tpu.geometry import camera
        from realsensetracker_tpu.mapping import tsdf

        W, H = 80, 60
        intr = camera.Intrinsics(
            fx=64.0, fy=64.0, cx=(W - 1) / 2, cy=(H - 1) / 2,
            width=W, height=H,
        )
        depths, _ = synthetic.render_trajectory(
            intr, 5, scene=synthetic.default_scene(seed=3), seed=1,
            step_scale=0.01,
        )
        t = Tracker(TrackerConfig(
            intrinsics=intr, method="tsdf",
            tsdf=tsdf.TsdfConfig(
                resolution=64, voxel_size=0.1, origin=(-3.2, -2.4, -0.3),
                trunc=0.3, max_range=5.0,
            ),
            projective=ProjectiveIcpConfig(
                iters=(3, 3), inner_iters=2, samples=768, min_samples=192
            ),
        ))
        res = t.process_window([np.asarray(d) for d in depths], window=2)
        assert len(res) == 5
        assert all(r.success for r in res)

    def test_cli_window_flag(self, tmp_path, capsys):
        import os

        from realsensetracker_tpu.cli import rs_replay
        from realsensetracker_tpu.data import recorded

        clip_path = os.path.join(tmp_path, "c.rsc")
        recorded.record_synthetic_clip(
            clip_path, num_frames=5, width=64, height=48
        )
        rc = rs_replay.main([
            "--record", clip_path, "--method", "tsdf", "--window", "3",
            "--tsdf-resolution", "48", "--tsdf-voxel", "0.08",
        ])
        assert rc == 0
        assert "processed 5 frames" in capsys.readouterr().out


class TestMultiEventWindow:
    """Non-truncating windows (truncate_at_events=False): keyframe events
    promote entirely in-scan, so a window never re-submits its tail --
    exactly ceil(N/W) dispatches -- while staying per-frame-identical
    (truncation wasted ~27% of scan rows at W=4 with events every ~6
    frames)."""

    def _run_multi_event(self, tracker, depths, window, pad=True):
        out = []
        i = 0
        while i < len(depths):
            chunk = depths[i : i + window]
            ts = [float(j) for j in range(i, i + len(chunk))]
            res = tracker.process_window(
                chunk, ts, pad_to=window if pad else None,
                truncate_at_events=False,
            )
            # Never truncates (the bootstrap call consumes only the seed).
            assert len(res) == (1 if i == 0 else len(chunk))
            out.extend(res)
            i += len(res)
        return out

    def test_matches_per_frame_with_multiple_events_per_window(self):
        # Aggressive motion: promotion roughly every 2 frames, so W=6
        # windows carry SEVERAL keyframe events each.
        depths = _sequence(13, step=(0.05, 0.0, 0.04, 0.0, 0.04, 0.0))
        kw = dict(max_translation=0.06, max_rotation=0.05)
        ref = KeyframeTracker(INTR, CFG, **kw)
        win = KeyframeTracker(INTR, CFG, **kw)
        a = _run_per_frame(ref, depths)
        b = self._run_multi_event(win, depths, window=6)
        assert sum(r.is_new_keyframe for r in a[1:]) >= 3
        _assert_results_match(a, b)
        # Adopted device carry continues identically afterwards.
        tail = _sequence(3, step=(0.01, 0.0, 0.01, 0.0, 0.0, 0.0))
        _assert_results_match(
            [ref.process(d, 100.0 + i) for i, d in enumerate(tail)],
            [win.process(d, 100.0 + i) for i, d in enumerate(tail)],
        )

    def test_through_failures_and_reseed(self):
        good = _sequence(4, step=(0.01, 0.0, 0.01, 0.0, 0.01, 0.0))
        dead = jnp.zeros_like(good[0])
        depths = good[:2] + [dead, dead] + good[2:]
        kw = dict(max_consecutive_failures=2)
        ref = KeyframeTracker(INTR, CFG, **kw)
        win = KeyframeTracker(INTR, CFG, **kw)
        _assert_results_match(
            _run_per_frame(ref, depths),
            self._run_multi_event(win, depths, window=4),
        )
        assert win._fail_streak == ref._fail_streak
        assert win._fails_since_kf == ref._fails_since_kf

    def test_uint16_ingestion_matches_float(self):
        # Raw u16 frames (native camera/TUM format) upload at half the
        # bytes and convert to meters ON DEVICE (depth * depth_scale);
        # results must match feeding the identically-quantized f32
        # frames, per-frame and windowed, through events.
        scale = np.float32(1.0 / 5000.0)
        depths_f = _sequence(9, step=(0.05, 0.0, 0.04, 0.0, 0.04, 0.0))
        raw = [np.asarray(np.asarray(d) * 5000.0 + 0.5, np.uint16)
               for d in depths_f]
        quant = [r.astype(np.float32) * scale for r in raw]
        kw = dict(max_translation=0.06, max_rotation=0.05)
        ref = KeyframeTracker(INTR, CFG, **kw)  # f32 path
        pf = KeyframeTracker(INTR, CFG, depth_scale=float(scale), **kw)
        win = KeyframeTracker(INTR, CFG, depth_scale=float(scale), **kw)
        a = _run_per_frame(ref, quant)
        b = _run_per_frame(pf, raw)
        c = self._run_multi_event(win, raw, window=4)
        assert sum(r.is_new_keyframe for r in a[1:]) >= 2
        _assert_results_match(a, b)
        _assert_results_match(a, c)

    def test_padding_inert_without_events(self):
        # Padded rows rely on row_valid (NOT the event latch) in this
        # mode: a short, event-free window padded to 8 must leave state
        # identical to the unpadded run.
        depths = _sequence(4, step=(0.005, 0.0, 0.005, 0.0, 0.0, 0.0))
        ref = KeyframeTracker(INTR, CFG)
        win = KeyframeTracker(INTR, CFG)
        a = _run_per_frame(ref, depths)
        win.process(depths[0], 0.0)
        res = win.process_window(depths[1:], [1.0, 2.0, 3.0], pad_to=8,
                                 truncate_at_events=False)
        assert len(res) == 3
        _assert_results_match(a[1:], res)
        assert win._index == ref._index


def _run_windowed_mode(tracker, depths, window, mode):
    """Drive KeyframeTracker.process_window in a given truncate mode,
    re-submitting unconsumed tails; returns (results, consumed-per-call)."""
    out, lens, i = [], [], 0
    while i < len(depths):
        chunk = depths[i : i + window]
        ts = [float(j) for j in range(i, i + len(chunk))]
        res = tracker.process_window(chunk, ts, pad_to=window,
                                     truncate_at_events=mode)
        out.extend(res)
        lens.append(len(res))
        i += len(res)
    return out, lens


class TestFailuresTruncateMode:
    """truncate_at_events="failures" (the SLAM window mode): successful
    promotions are consumed in-scan -- whole windows, 1/W dispatches --
    while a recovery re-seed latches the carry so the host can act."""

    def test_promotions_consume_whole_windows(self):
        depths = _sequence(9)
        kw = dict(max_translation=0.06, max_rotation=0.05)
        ref = KeyframeTracker(INTR, CFG, **kw)
        win = KeyframeTracker(INTR, CFG, **kw)
        ra = _run_per_frame(ref, depths)
        rb, lens = _run_windowed_mode(win, depths, 4, "failures")
        _assert_results_match(ra, rb)
        assert sum(r.is_new_keyframe for r in ra[1:]) >= 2
        # Promotions did NOT truncate: bootstrap + two full windows.
        assert lens == [1, 4, 4]
        # Per-event span_failures ride the results (clean spans here).
        for x, y in zip(ra, rb):
            assert x.span_failures == y.span_failures == 0

    def test_truncates_at_recovery_reseed(self):
        good = _sequence(4, step=(0.01, 0.0, 0.01, 0.0, 0.01, 0.0))
        dead = [jnp.zeros_like(good[0])] * 3
        tail = [good[-1]] * 2
        depths = good + dead + tail
        kw = dict(max_consecutive_failures=2, max_translation=10.0,
                  max_rotation=10.0)
        ref = KeyframeTracker(INTR, CFG, **kw)
        win = KeyframeTracker(INTR, CFG, **kw)
        ra = _run_per_frame(ref, depths)
        rb, lens = _run_windowed_mode(win, depths, 4, "failures")
        _assert_results_match(ra, rb)
        # A failure-streak re-seed fired and latched its window: the call
        # that contains it returns early (its last row is the re-seed).
        reseeds = [r for r in ra if r.is_new_keyframe and not r.success]
        assert reseeds
        assert any(n < 4 for n in lens[1:])
        for x, y in zip(ra, rb):
            assert x.span_failures == y.span_failures
        assert ref.last_span_failures == win.last_span_failures
        assert ref._fail_streak == win._fail_streak


class TestWindowedSlamDeferred:
    """SlamConfig.window_defer_events: promotions consumed in-scan, host
    bookkeeping (loop closure, graph edges) deferred to after the
    dispatch -- identical results, ~1/W dispatches."""

    def _make(self, **kw):
        cfg = SlamConfig(
            intrinsics=INTR,
            icp=CFG,
            loop_min_separation=3,
            loop_similarity=0.8,
            keyframe_cloud_capacity=1024,
            **kw,
        )
        cfg.align.fpfh_max_neighbors = 32
        t = SlamTracker(cfg)
        t._vo.max_translation = 0.05
        t._vo.max_rotation = 0.05
        return t

    def _out_and_back(self, n=10):
        scene = synthetic.default_scene(seed=21)
        step = jnp.asarray([0.03, 0.0, 0.02, 0.0, 0.025, 0.0], jnp.float32)
        poses = [se3.identity()]
        for i in range(n - 1):
            s = step if i < n // 2 else -step
            poses.append(se3.compose(poses[-1], se3.exp(s)))
        return [synthetic.render_depth(INTR, T, scene) for T in poses]

    def test_deferred_matches_truncating_and_per_frame(self):
        depths = self._out_and_back()
        ref = self._make()
        trunc = self._make(window_defer_events=False)
        defer = self._make(window_defer_events=True)
        ra = _run_per_frame(ref, depths)
        rb = _run_windowed(trunc, depths, window=4)
        rc = _run_windowed(defer, depths, window=4)
        _assert_results_match(ra, rb)
        _assert_results_match(ra, rc)
        assert defer.keyframe_count == ref.keyframe_count >= 2
        assert defer.num_loop_closures == ref.num_loop_closures
        for pa, pc in zip(ref.trajectory.poses, defer.trajectory.poses):
            np.testing.assert_allclose(pa, pc, atol=1e-5)
        oa, oc = ref.optimize(), defer.optimize()
        if oa is not None:
            np.testing.assert_allclose(oa, oc, atol=1e-4)

    def test_deferred_with_online_optimize(self):
        # optimize_every > 0: deferred corrections apply at window
        # boundaries instead of mid-window -- trajectories stay close
        # (bounded by one window of staleness), graph structure identical.
        depths = self._out_and_back(12)
        ref = self._make(optimize_every=2)
        defer = self._make(optimize_every=2, window_defer_events=True)
        ra = _run_per_frame(ref, depths)
        rc = _run_windowed(defer, depths, window=4)
        assert len(ra) == len(rc)
        assert defer.keyframe_count == ref.keyframe_count
        assert defer.num_loop_closures == ref.num_loop_closures
        if ref.num_online_optimizations:
            assert defer.num_online_optimizations
        for pa, pc in zip(ref.trajectory.poses, defer.trajectory.poses):
            np.testing.assert_allclose(pa, pc, atol=5e-2)

    def test_rgbd_deferred_matches_per_frame_and_truncating(self):
        from realsensetracker_tpu.align.rgbd import RgbdIcpConfig

        scene = synthetic.default_scene(seed=13)
        step = jnp.asarray([0.025, 0.0, 0.02, 0.0, 0.02, 0.0], jnp.float32)
        poses = [se3.identity()]
        for _ in range(7):
            poses.append(se3.compose(poses[-1], se3.exp(step)))
        depths, grays = [], []
        for T in poses:
            d, rgb = synthetic.render_rgbd(INTR, T, scene)
            depths.append(d)
            grays.append(synthetic.intensity_from_rgb(rgb))

        def make(**kw):
            cfg = SlamConfig(
                intrinsics=INTR, use_rgb=True,
                rgbd=RgbdIcpConfig(iters=(4, 4), samples=768),
                keyframe_cloud_capacity=1024, **kw,
            )
            cfg.align.fpfh_max_neighbors = 32
            t = SlamTracker(cfg)
            t._vo.max_translation = 0.05
            t._vo.max_rotation = 0.05
            return t

        def windowed(t):
            out, i = [], 0
            while i < len(depths):
                res = t.process_window(
                    depths[i:], [float(j) for j in range(i, len(depths))],
                    window=4, grays=grays[i:],
                )
                out.extend(res)
                i += len(res)
            return out

        ref = make()
        ra = [ref.process(d, float(i), gray=g)
              for i, (d, g) in enumerate(zip(depths, grays))]
        trunc, defer = make(window_defer_events=False), make()
        rb, rc = windowed(trunc), windowed(defer)
        _assert_results_match(ra, rb)
        _assert_results_match(ra, rc)
        assert sum(r.is_new_keyframe for r in ra[1:]) >= 1
        assert defer.keyframe_count == ref.keyframe_count

    def test_rgbd_padding_inert_without_events(self):
        # RGB-D windows now freeze padded rows via row_valid (previously
        # padded duplicates were live and only host discarding hid them):
        # a short event-free window padded to 8 must match per-frame.
        from realsensetracker_tpu.align.rgbd import RgbdIcpConfig
        from realsensetracker_tpu.tracking.keyframe_rgbd import (
            RgbdKeyframeTracker,
        )

        scene = synthetic.default_scene(seed=13)
        step = jnp.asarray([0.004, 0.0, 0.004, 0.0, 0.0, 0.0], jnp.float32)
        poses = [se3.identity()]
        for _ in range(3):
            poses.append(se3.compose(poses[-1], se3.exp(step)))
        depths, grays = [], []
        for T in poses:
            d, rgb = synthetic.render_rgbd(INTR, T, scene)
            depths.append(d)
            grays.append(synthetic.intensity_from_rgb(rgb))
        cfg = RgbdIcpConfig(iters=(4, 4), samples=768)
        ref = RgbdKeyframeTracker(INTR, cfg)
        win = RgbdKeyframeTracker(INTR, cfg)
        ra = [ref.process(d, g, float(i))
              for i, (d, g) in enumerate(zip(depths, grays))]
        win.process(depths[0], grays[0], 0.0)
        res = win.process_window(depths[1:], grays[1:], [1.0, 2.0, 3.0],
                                 pad_to=8, truncate_at_events=False)
        assert len(res) == 3
        _assert_results_match(ra[1:], res)
        assert win._index == ref._index
        assert win._fail_streak == ref._fail_streak

    def test_online_optimize_defers_to_window_boundary(self):
        # Review fix: a mid-window _optimize_online between two
        # same-window keyframe bookings would rewrite keyframe k's
        # stored pose while k+1's in-scan pose is already fixed,
        # contaminating the odometry edge between them. The deferred
        # path must book ALL of a window's keyframes first and optimize
        # once at the boundary.
        depths = self._out_and_back(12)
        t = self._make(optimize_every=1)
        order = []
        orig_win = t._vo.process_window
        orig_kf = t._on_keyframe
        orig_opt = t._optimize_online

        def spy_win(*a, **k):
            order.append("win")
            return orig_win(*a, **k)

        def spy_kf(*a, **k):
            order.append("kf")
            return orig_kf(*a, **k)

        def spy_opt():
            order.append("opt")
            return orig_opt()

        t._vo.process_window = spy_win
        t._on_keyframe = spy_kf
        t._optimize_online = spy_opt
        _run_windowed(t, depths, window=8)
        assert order.count("opt") >= 1  # the cadence fired at least once
        # Within every window (a "win".."win" segment), no optimize may
        # run between two keyframe bookings.
        segs, cur = [], []
        for ev in order:
            if ev == "win":
                segs.append(cur)
                cur = []
            else:
                cur.append(ev)
        segs.append(cur)
        for seg in segs:
            if "opt" in seg:
                assert "kf" not in seg[seg.index("opt"):], seg
        # And at least one window booked >= 2 keyframes, so the ordering
        # property was actually exercised.
        assert any(seg.count("kf") >= 2 for seg in segs)
