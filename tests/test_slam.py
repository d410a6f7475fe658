"""SLAM integration test: keyframe VO + loop closure + pose-graph
optimization over a synthetic trajectory that revisits its start."""

import jax.numpy as jnp
import numpy as np

from realsensetracker_tpu.align import projective
from realsensetracker_tpu.data import synthetic
from realsensetracker_tpu.geometry import camera, se3
from realsensetracker_tpu.tracking.slam import SlamConfig, SlamTracker

INTR = camera.Intrinsics(fx=100.0, fy=100.0, cx=49.5, cy=37.0, width=100, height=75)


def _loop_sequence(n=10):
    """Out-and-back trajectory: the final frames revisit the first pose."""
    scene = synthetic.default_scene(seed=21)
    half = n // 2
    twists = []
    step = jnp.asarray([0.03, 0.0, 0.02, 0.0, 0.025, 0.0], jnp.float32)
    twists = [step] * half + [-step] * (n - 1 - half)
    poses = [se3.identity()]
    for tw in twists:
        poses.append(se3.compose(poses[-1], se3.exp(tw)))
    depths = jnp.stack([synthetic.render_depth(INTR, T, scene) for T in poses])
    return depths, jnp.stack(poses)


def _make_tracker(force_keyframes=True):
    cfg = SlamConfig(
        intrinsics=INTR,
        icp=projective.ProjectiveIcpConfig(iters=(5, 5, 6), samples=1024),
        loop_min_separation=3,
        loop_similarity=0.8,
        keyframe_cloud_capacity=1024,
    )
    cfg.align.fpfh_max_neighbors = 32
    tracker = SlamTracker(cfg)
    if force_keyframes:
        # Promote every frame to keyframe for a dense graph in this test.
        tracker._vo.max_translation = 1e-6
        tracker._vo.max_rotation = 1e-6
    return tracker


class TestSlam:
    def test_tracks_and_builds_keyframes(self):
        depths, _ = _loop_sequence(6)
        tracker = _make_tracker()
        for i in range(6):
            res = tracker.process(depths[i], float(i))
            assert res.success
        assert tracker.keyframe_count >= 5
        assert len(tracker.trajectory) == 6

    def test_loop_closure_detected_on_revisit(self):
        depths, _ = _loop_sequence(10)
        tracker = _make_tracker()
        for i in range(10):
            tracker.process(depths[i], float(i))
        # Out-and-back: the final keyframes see the start again.
        assert tracker.num_loop_closures >= 1

    def test_verifier_rejects_wrong_loops_without_odometry_gate(self):
        """Self-similar sphere scenes produce confidently
        wrong global registrations; the verifier's symmetric-overlap check
        must reject them BY ITSELF (odometry gate disabled), while keeping
        the true revisit edges."""
        # seed 9 historically produced 11 wrong edges (twist err 1.5-6.0)
        # through the old verifier; only 3<-7, 2<-8, 1<-9 are true loops.
        scene = synthetic.default_scene(seed=9)
        step = jnp.asarray([0.03, 0.0, 0.02, 0.0, 0.025, 0.0], jnp.float32)
        twists = [step] * 5 + [-step] * 4
        poses = [se3.identity()]
        for tw in twists:
            poses.append(se3.compose(poses[-1], se3.exp(tw)))
        depths = jnp.stack([synthetic.render_depth(INTR, T, scene) for T in poses])

        cfg = SlamConfig(
            intrinsics=INTR,
            icp=projective.ProjectiveIcpConfig(iters=(5, 5, 6), samples=1024),
            loop_min_separation=3,
            loop_similarity=0.8,
            keyframe_cloud_capacity=1024,
            loop_odometry_gate=1e9,  # gate DISABLED: verifier stands alone
        )
        cfg.align.fpfh_max_neighbors = 32
        tracker = SlamTracker(cfg)
        tracker._vo.max_translation = 1e-6
        tracker._vo.max_rotation = 1e-6
        for i in range(10):
            tracker.process(depths[i], float(i))

        assert tracker.num_loop_closures >= 1, "true revisits must survive"
        P = np.asarray(jnp.stack(poses))
        for (i, j, T, _w) in tracker._loop_edges:
            T_true = np.linalg.inv(P[i]) @ P[j]
            err = np.linalg.norm(
                np.asarray(
                    se3.log(jnp.asarray(np.linalg.inv(T) @ T_true, jnp.float32))
                )
            )
            assert err < 0.05, f"wrong loop edge {i}<-{j} accepted (err {err:.3f})"

    def test_deferred_booking_matches_synchronous(self):
        """SlamConfig.defer_keyframe_booking pipelines keyframe prep +
        loop verification over the two frames after each promotion; every
        quantity is snapshotted at event time, so keyframes, loop edges,
        counters, trajectory, and the optimized poses must be IDENTICAL
        to synchronous booking."""
        depths, _ = _loop_sequence(10)
        out = {}
        for defer in (False, True):
            tracker = _make_tracker()
            tracker.config.defer_keyframe_booking = defer
            for i in range(10):
                tracker.process(depths[i], float(i))
            opt = tracker.optimize(gn_iters=6, cg_iters=30)
            out[defer] = (
                tracker.keyframe_count,
                tracker.num_loop_closures,
                [(i, j, np.asarray(T), w)
                 for (i, j, T, w) in tracker._loop_edges],
                np.stack(tracker.trajectory.poses),
                np.asarray(opt),
            )
        assert out[False][0] == out[True][0]
        assert out[False][1] == out[True][1]
        for (i0, j0, T0, w0), (i1, j1, T1, w1) in zip(out[False][2],
                                                      out[True][2]):
            assert (i0, j0, w0) == (i1, j1, w1)
            np.testing.assert_allclose(T0, T1, atol=1e-6)
        np.testing.assert_allclose(out[False][3], out[True][3], atol=1e-6)
        np.testing.assert_allclose(out[False][4], out[True][4], atol=1e-5)

    def test_deferred_booking_matches_synchronous_natural_cadence(self):
        """With NATURAL promotion thresholds (events every few frames)
        the pipeline genuinely advances one stage per non-event frame
        (_advance_pending) instead of being flushed at every event; the
        results must still match synchronous booking exactly."""
        depths, _ = _loop_sequence(12)
        out = {}
        for defer in (False, True):
            tracker = _make_tracker(force_keyframes=False)
            tracker.config.defer_keyframe_booking = defer
            tracker._vo.max_translation = 0.05
            tracker._vo.max_rotation = 0.05
            for i in range(12):
                tracker.process(depths[i], float(i))
            out[defer] = (
                tracker.keyframe_count,
                tracker.num_loop_closures,
                np.stack(tracker.trajectory.poses),
            )
        assert out[False][0] == out[True][0]
        assert out[False][0] >= 2, "cadence produced no natural keyframes"
        assert out[False][1] == out[True][1]
        np.testing.assert_allclose(out[False][2], out[True][2], atol=1e-6)

    def test_deferred_booking_flushes_on_reads(self):
        """keyframe_count / num_loop_closures mid-stream must include a
        still-pipelined promotion (the properties flush)."""
        depths, _ = _loop_sequence(6)
        tracker = _make_tracker()
        tracker.config.defer_keyframe_booking = True
        counts = []
        for i in range(6):
            tracker.process(depths[i], float(i))
            counts.append(tracker.keyframe_count)
        # force_keyframes promotes every frame; the flushing property
        # must never lag the frame count.
        assert counts == list(range(1, 7))

    def test_optimize_improves_endpoint(self):
        depths, poses_gt = _loop_sequence(10)
        tracker = _make_tracker()
        for i in range(10):
            tracker.process(depths[i], float(i))
        if tracker.num_loop_closures == 0:
            import pytest

            pytest.skip("no loop closures found on this synthetic sequence")
        before = np.stack([k.pose for k in tracker._keyframes])
        gt_end = np.asarray(poses_gt[-1])
        err_before = np.linalg.norm(before[-1][:3, 3] - gt_end[:3, 3])
        opt = tracker.optimize(gn_iters=8, cg_iters=40)
        err_after = np.linalg.norm(opt[-1][:3, 3] - gt_end[:3, 3])
        assert np.isfinite(opt).all()
        # Loop closure must not make the endpoint worse.
        assert err_after <= err_before + 1e-4

    def test_relocalization_recovers_from_lost_tracking(self):
        """When projective ICP is blinded (invalid frames) and the camera
        reappears at a different pose, the SLAM layer must recover the
        pose by robust global registration against recent keyframes
        (SlamConfig.relocalize) instead of holding the stale estimate."""
        scene = synthetic.default_scene(seed=21)
        step = jnp.asarray([0.03, 0.0, 0.02, 0.0, 0.025, 0.0], jnp.float32)
        poses = [se3.identity()]
        for _ in range(3):
            poses.append(se3.compose(poses[-1], se3.exp(step)))
        # Frames 0-3: tracked. Frames 4-5: blind (all-invalid depth).
        # Frames 6-7: camera reappears AT FRAME 1's POSE (held estimate is
        # frame 3's). Frames 8-9: resume stepping from there.
        reappear = [poses[1]]
        for _ in range(3):
            reappear.append(se3.compose(reappear[-1], se3.exp(step)))
        good = [synthetic.render_depth(INTR, T, scene) for T in poses]
        blind = jnp.zeros_like(good[0])
        back = [synthetic.render_depth(INTR, T, scene) for T in reappear]
        frames = good + [blind, blind] + back
        gt_final = np.asarray(reappear[-1])

        tracker = _make_tracker()
        tracker._vo.max_consecutive_failures = 2
        for i, d in enumerate(frames):
            res = tracker.process(d, float(i))
        assert tracker.num_relocalizations >= 1
        assert res.success, "tracking must resume after relocalization"
        # The chain edge into a relocalized keyframe measures stale-held
        # drift + unobserved motion: it must be FLOORED (not merely
        # loop-weighted -- measured on the 500-frame sweep, a 0.25 jump
        # edge poisons optimization, ATE 1062 -> 1285 mm), and the
        # verified registration must instead be recorded as a loop edge
        # to the matched keyframe.
        floor = tracker.config.reloc_odom_weight
        assert any(
            abs(k.odom_weight - floor) < 1e-9 for k in tracker._keyframes[1:]
        )
        reloc_nodes = [
            k.index for k in tracker._keyframes[1:]
            if abs(k.odom_weight - floor) < 1e-9
        ]
        assert any(j in reloc_nodes for (_i, j, _T, _w) in tracker._loop_edges), (
            "relocalization must add a loop edge anchoring the recovered node"
        )
        final = np.asarray(tracker.trajectory.poses[-1])
        err = np.linalg.norm(
            np.asarray(
                se3.log(jnp.asarray(np.linalg.inv(gt_final) @ final, jnp.float32))
            )
        )
        # Without relocalization the pose error would be ~2 lost steps
        # (>= 0.08 twist) plus the blind-stretch drift; recovered tracking
        # must land well inside that.
        assert err < 0.04, err

    def test_padded_optimize_matches_unpadded(self):
        """Capacity padding (pad=True: pose/edge counts rounded up so
        online optimization reuses one compiled program per capacity) must
        be EXACTLY inert: the padded subspace is fully decoupled."""
        import copy

        depths, _ = _loop_sequence(10)
        tracker = _make_tracker()
        for i in range(10):
            tracker.process(depths[i], float(i))
        if tracker.num_loop_closures == 0:
            import pytest

            pytest.skip("no loop closures found on this synthetic sequence")
        twin = copy.deepcopy(tracker)
        opt_plain = tracker.optimize(gn_iters=6, cg_iters=40, pad=False)
        opt_pad = twin.optimize(gn_iters=6, cg_iters=40, pad=True)
        assert opt_pad.shape == opt_plain.shape  # padding stripped
        np.testing.assert_allclose(opt_pad, opt_plain, atol=1e-5)

    def test_online_optimization_feeds_back(self):
        """SlamConfig.optimize_every: once loop edges exist the graph
        optimizes IN-STREAM and the correction feeds back into the VO."""
        depths, poses_gt = _loop_sequence(10)
        tracker = _make_tracker()
        tracker.config.optimize_every = 2
        for i in range(10):
            tracker.process(depths[i], float(i))
        if tracker.num_loop_closures == 0:
            import pytest

            pytest.skip("no loop closures found on this synthetic sequence")
        assert tracker.num_online_optimizations >= 1
        traj = np.stack(tracker.trajectory.poses)
        assert np.isfinite(traj).all()
        gt_end = np.asarray(poses_gt[-1])
        err = np.linalg.norm(traj[-1][:3, 3] - gt_end[:3, 3])
        assert err < 0.05, err

    def test_map_builds_from_keyframes(self):
        depths, _ = _loop_sequence(6)
        tracker = _make_tracker()
        for i in range(6):
            tracker.process(depths[i], float(i))
        m = tracker.build_map(voxel_size=0.1, capacity=1 << 14)
        assert int(m.count()) > 100


class TestKeyframePrep:
    def test_capacity_overflow_subsamples_uniformly(self):
        """When occupied voxels exceed keyframe_cloud_capacity, the
        reduction must take evenly spaced survivors: survivors are
        compacted in sorted packed-key (x-major) order, so the old head
        slice kept only the lowest-x region of the scene."""
        from realsensetracker_tpu.tracking import slam as slam_mod

        depth = synthetic.render_depth(INTR, se3.identity(),
                                       synthetic.default_scene(seed=3))
        kw = dict(intr=INTR, voxel_size=0.02, normal_k=8,
                  feature_radius=0.5, max_neighbors=16)
        # Reference extent from an overflow-free run.
        full_cloud, _, _ = slam_mod._fused_keyframe_prep(
            depth, capacity=8192, **kw)
        full_pts = np.asarray(full_cloud.points)[np.asarray(full_cloud.mask)]
        n_survivors = len(full_pts)
        cap = 256
        assert n_survivors > 2 * cap, "scene too small to exercise overflow"

        small_cloud, feats, _ = slam_mod._fused_keyframe_prep(
            depth, capacity=cap, **kw)
        m = np.asarray(small_cloud.mask)
        pts = np.asarray(small_cloud.points)[m]
        assert m.sum() == cap
        # Uniform selection spans (almost) the full x extent; a head slice
        # keeps only the low-x prefix of the key-sorted survivors.
        lo, hi = full_pts[:, 0].min(), full_pts[:, 0].max()
        span = hi - lo
        assert pts[:, 0].min() < lo + 0.15 * span
        assert pts[:, 0].max() > hi - 0.15 * span
        head_hi = full_pts[:cap, 0].max()  # what the old slice would keep
        assert head_hi < hi - 0.15 * span, "scene does not separate the behaviors"
        assert np.isfinite(np.asarray(feats)[m]).all()

    def test_capacity_underflow_keeps_all_survivors(self):
        from realsensetracker_tpu.tracking import slam as slam_mod

        depth = synthetic.render_depth(INTR, se3.identity(),
                                       synthetic.default_scene(seed=3))
        kw = dict(intr=INTR, voxel_size=0.05, normal_k=8,
                  feature_radius=0.5, max_neighbors=16)
        big, _, _ = slam_mod._fused_keyframe_prep(depth, capacity=8192, **kw)
        n = int(np.asarray(big.mask).sum())
        assert 0 < n < 8192
        pts = np.asarray(big.points)[np.asarray(big.mask)]
        assert np.unique(pts, axis=0).shape[0] == n  # no duplicated rows


class TestHostSe3Log:
    def test_matches_device_log(self):
        from realsensetracker_tpu.tracking.slam import _se3_log_np

        rng = np.random.RandomState(0)
        for _ in range(10):
            tw = rng.randn(6).astype(np.float32) * 0.6
            T = np.asarray(se3.exp(jnp.asarray(tw)))
            np.testing.assert_allclose(
                _se3_log_np(T), np.asarray(se3.log(jnp.asarray(T))),
                atol=1e-5,
            )

    def test_small_and_near_pi_angles(self):
        from realsensetracker_tpu.tracking.slam import _se3_log_np

        # Tiny rotation: the small-angle branch must return the translation
        # unchanged (twist layout is [t, w], translation first).
        tiny = np.asarray(se3.exp(jnp.asarray(
            [0.1, -0.2, 0.3, 1e-9, 0, 0], jnp.float32)))
        got = _se3_log_np(tiny)
        np.testing.assert_allclose(got[:3], [0.1, -0.2, 0.3], atol=1e-5)
        # Near-pi rotations are gate-rejected via an inf twist, never NaN.
        near_pi = np.asarray(se3.exp(jnp.asarray(
            [0, 0, 0, np.pi - 1e-8, 0, 0], jnp.float32)))
        out = _se3_log_np(near_pi)
        assert not np.isnan(out).any()


class TestU16Slam:
    """Raw uint16 frames through SLAM: the VO converts on device
    (tracking/keyframe.py), host logic (keyframe features, loop closure,
    relocalization clouds, kept depths) converts lazily at events --
    results must match feeding identically-quantized f32 meters."""

    def test_u16_matches_f32_through_loop_closure(self):
        depths, _ = _loop_sequence(8)
        scale = 1.0 / 5000.0
        raw = [np.asarray(np.asarray(d) * 5000.0 + 0.5, np.uint16)
               for d in depths]
        quant = [r.astype(np.float32) * np.float32(scale) for r in raw]
        a = _make_tracker()
        b = _make_tracker()
        b.config.depth_scale = scale
        b._vo.depth_scale = scale
        ra = [a.process(d, float(i)) for i, d in enumerate(quant)]
        rb = [b.process(d, float(i)) for i, d in enumerate(raw)]
        assert a.keyframe_count == b.keyframe_count
        assert a.num_loop_closures == b.num_loop_closures
        for x, y in zip(ra, rb):
            assert x.success == y.success
            np.testing.assert_allclose(x.pose, y.pose, atol=1e-5)
        # kept state (keyframe clouds) converted: optimize agrees too
        oa, ob = a.optimize(), b.optimize()
        if oa is not None:
            np.testing.assert_allclose(oa, ob, atol=1e-4)


class TestPrepScale:
    """SlamConfig.keyframe_prep_scale: keyframe clouds from the reduced
    pyramid level (latency knob for the prep program's sort cost)."""

    def test_prep_scale_2_closes_loops(self):
        tr = _make_tracker()
        tr.config.keyframe_prep_scale = 2
        depths, _poses = _loop_sequence()
        for i in range(depths.shape[0]):
            tr.process(depths[i], float(i))
        assert tr.keyframe_count >= 3
        assert tr.num_loop_closures >= 1

    def test_prep_scale_cloud_geometry_close(self):
        """The reduced-level cloud occupies (nearly) the same voxel set:
        mean nearest-neighbor distance between the scale-1 and scale-2
        keyframe clouds stays well under the keyframe voxel size."""
        from realsensetracker_tpu.tracking import slam as slam_mod

        cfg = _make_tracker().config
        depths, _ = _loop_sequence()
        clouds = []
        for s in (1, 2):
            c, _f, _d = slam_mod._fused_keyframe_prep(
                depths[0],
                intr=cfg.intrinsics,
                voxel_size=float(cfg.align.voxel_size),
                normal_k=int(cfg.align.normal_k),
                feature_radius=float(cfg.align.feature_radius),
                max_neighbors=int(cfg.align.fpfh_max_neighbors),
                capacity=int(cfg.keyframe_cloud_capacity),
                prep_scale=s,
            )
            clouds.append(c)
        a, b = clouds
        pa = np.asarray(a.points)[np.asarray(a.mask)]
        pb = np.asarray(b.points)[np.asarray(b.mask)]
        d2 = ((pa[:, None, :] - pb[None, :, :]) ** 2).sum(-1)
        nn = np.sqrt(d2.min(axis=1))
        assert nn.mean() < cfg.align.voxel_size
