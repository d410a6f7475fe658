"""RGB-D SLAM: joint geometric+photometric odometry inside the SLAM layer.

The depth-only VO's known failure mode is geometry-degenerate motion
(flat wall: point-to-plane leaves in-plane translation unobservable --
the "seed-11 sliding ambiguity" of the synthetic scene). These tests
check that SlamConfig.use_rgb swaps in the RGB-D keyframe tracker and
that it tracks where the depth-only VO demonstrably slides.
"""

import jax.numpy as jnp
import numpy as np

from realsensetracker_tpu.align.rgbd import RgbdIcpConfig
from realsensetracker_tpu.data import synthetic
from realsensetracker_tpu.geometry import camera, se3
from realsensetracker_tpu.tracking.keyframe_rgbd import RgbdKeyframeTracker
from realsensetracker_tpu.tracking.slam import SlamConfig, SlamTracker

INTR = camera.Intrinsics(fx=100.0, fy=100.0, cx=49.5, cy=37.0, width=100, height=75)
RGBD_CFG = RgbdIcpConfig(iters=(5, 5, 6), samples=1024)


def _textured_sequence(n, scene=None, step=None, seed=5):
    """(depths, grays, gt_poses) along a straight twist trajectory."""
    scene = scene or synthetic.default_scene(seed=seed)
    step = (
        jnp.asarray([0.03, 0.0, 0.02, 0.0, 0.025, 0.0], jnp.float32)
        if step is None
        else step
    )
    poses = [se3.identity()]
    for _ in range(n - 1):
        poses.append(se3.compose(poses[-1], se3.exp(step)))
    depths, grays = [], []
    for T in poses:
        d, c = synthetic.render_rgbd(INTR, T, scene)
        depths.append(d)
        grays.append(synthetic.intensity_from_rgb(c))
    return jnp.stack(depths), jnp.stack(grays), jnp.stack(poses)


def _wall_scene():
    """Geometry-degenerate scene: a flat textured wall fills the view."""
    return synthetic.Scene(
        sphere_centers=jnp.full((1, 3), 100.0),
        sphere_radii=jnp.full((1,), 0.01),
        floor_y=100.0,
        wall_z=3.0,
    )


def _ate_rmse(est_poses, gt_poses):
    err = [
        np.linalg.norm(np.asarray(e)[:3, 3] - np.asarray(g)[:3, 3])
        for e, g in zip(est_poses, gt_poses)
    ]
    return float(np.sqrt(np.mean(np.square(err))))


class TestRgbdKeyframeTracker:
    def test_tracks_textured_trajectory(self):
        depths, grays, gt = _textured_sequence(6)
        tr = RgbdKeyframeTracker(INTR, RGBD_CFG)
        for i in range(6):
            res = tr.process(depths[i], grays[i], float(i))
            assert res.success
        assert _ate_rmse(tr.trajectory.poses, gt) < 5e-3

    def test_tracks_wall_slide_where_depth_only_fails(self):
        # In-plane translation + roll on a flat wall: the depth-only
        # keyframe VO converges confidently to a WRONG (slid) pose; the
        # photometric term pins it. This is the VO-level version of
        # tests/test_rgbd.py::test_constrains_geometry_degenerate_slide.
        from realsensetracker_tpu.align import projective
        from realsensetracker_tpu.tracking.keyframe import KeyframeTracker

        scene = _wall_scene()
        step = jnp.asarray([0.012, -0.009, 0.0, 0.0, 0.0, 0.006], jnp.float32)
        depths, grays, gt = _textured_sequence(5, scene=scene, step=step)

        depth_vo = KeyframeTracker(
            INTR, projective.ProjectiveIcpConfig(iters=(5, 5, 6), samples=1024)
        )
        rgb_vo = RgbdKeyframeTracker(INTR, RGBD_CFG)
        for i in range(5):
            depth_vo.process(depths[i], float(i))
            res = rgb_vo.process(depths[i], grays[i], float(i))
            assert res.success
        err_depth = _ate_rmse(depth_vo.trajectory.poses, gt)
        err_rgb = _ate_rmse(rgb_vo.trajectory.poses, gt)
        assert err_depth > 5e-3  # geometry alone genuinely slides here
        assert err_rgb < 2e-3
        assert err_rgb < err_depth / 4

    def test_keyframe_promotion_and_failure_semantics(self):
        depths, grays, _ = _textured_sequence(4)
        tr = RgbdKeyframeTracker(INTR, RGBD_CFG)
        tr.max_translation = 1e-6  # force promotion every frame
        tr.max_rotation = 1e-6
        for i in range(4):
            res = tr.process(depths[i], grays[i], float(i))
            assert res.is_new_keyframe
        # A garbage frame fails and holds the pose (reference semantics,
        # rs_replay_app.cpp:266-273).
        pose_before = tr.pose.copy()
        bad = jnp.zeros_like(depths[0])
        res = tr.process(bad, jnp.zeros_like(grays[0]), 99.0)
        assert not res.success
        np.testing.assert_array_equal(tr.pose, pose_before)


class TestRgbdSlam:
    def test_slam_use_rgb_tracks_and_keyframes(self):
        depths, grays, gt = _textured_sequence(6)
        cfg = SlamConfig(
            intrinsics=INTR,
            use_rgb=True,
            rgbd=RGBD_CFG,
            loop_min_separation=3,
            keyframe_cloud_capacity=1024,
        )
        cfg.align.fpfh_max_neighbors = 32
        tracker = SlamTracker(cfg)
        tracker._vo.max_translation = 1e-6  # dense keyframes for the test
        tracker._vo.max_rotation = 1e-6
        for i in range(6):
            res = tracker.process(depths[i], float(i), gray=grays[i])
            assert res.success
        assert tracker.keyframe_count >= 5
        assert _ate_rmse(tracker.trajectory.poses, gt) < 5e-3
        # Loop closure machinery (geometric, depth-based) still runs.
        opt = tracker.optimize()
        assert opt is not None and np.isfinite(opt).all()

    def test_use_rgb_requires_gray(self):
        cfg = SlamConfig(intrinsics=INTR, use_rgb=True, rgbd=RGBD_CFG)
        tracker = SlamTracker(cfg)
        d = jnp.ones((75, 100), jnp.float32)
        try:
            tracker.process(d, 0.0)
        except ValueError as e:
            assert "gray" in str(e)
        else:
            raise AssertionError("expected ValueError without gray")

    def test_rgb_slam_checkpoint_roundtrip(self, tmp_path):
        from realsensetracker_tpu.tracking import checkpoint

        depths, grays, _ = _textured_sequence(5)
        cfg = SlamConfig(
            intrinsics=INTR, use_rgb=True, rgbd=RGBD_CFG,
            keyframe_cloud_capacity=1024,
        )
        cfg.align.fpfh_max_neighbors = 32
        a = SlamTracker(cfg)
        a._vo.max_translation = 1e-6
        a._vo.max_rotation = 1e-6
        for i in range(3):
            a.process(depths[i], float(i), gray=grays[i])
        path = str(tmp_path / "slam_rgb.npz")
        checkpoint.save_slam(path, a)

        b = SlamTracker(cfg)
        b._vo.max_translation = 1e-6  # same promotion policy as `a`
        b._vo.max_rotation = 1e-6
        checkpoint.load_slam(path, b)
        # Resumed tracker continues IDENTICALLY to the uninterrupted one.
        for i in range(3, 5):
            ra = a.process(depths[i], float(i), gray=grays[i])
            rb = b.process(depths[i], float(i), gray=grays[i])
            np.testing.assert_allclose(ra.pose, rb.pose, atol=1e-6)
        assert b.keyframe_count == a.keyframe_count

        # Mismatched VO type is refused with a clear error.
        c = SlamTracker(SlamConfig(intrinsics=INTR, use_rgb=False))
        try:
            checkpoint.load_slam(path, c)
        except ValueError as e:
            assert "RGB-D" in str(e)
        else:
            raise AssertionError("expected VO-mismatch ValueError")
