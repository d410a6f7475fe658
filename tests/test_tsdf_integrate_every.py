"""Integrate decimation (TsdfConfig.integrate_every).

The full-resolution integrate pass is the dense tracked step's cost
floor once the render is reduced (TsdfConfig.track_scale);
fusing every Nth tracked frame divides it by N -- the standard
KinectFusion economy. Pose estimation still runs every frame; the fused
map is a strict cadence-subsample of the N=1 map.
"""

import jax.numpy as jnp
import numpy as np

from realsensetracker_tpu.align.projective import ProjectiveIcpConfig
from realsensetracker_tpu.data import synthetic
from realsensetracker_tpu.geometry import camera
from realsensetracker_tpu.mapping import tsdf
from realsensetracker_tpu.tracking.tsdf_tracker import TsdfTracker

W, H = 160, 120
INTR = camera.Intrinsics(
    fx=128.0, fy=128.0, cx=(W - 1) / 2, cy=(H - 1) / 2, width=W, height=H
)
CFG = tsdf.TsdfConfig(
    resolution=64,
    voxel_size=0.1,
    origin=(-3.2, -2.4, -0.3),
    trunc=0.3,
    max_range=5.0,
)
ICP = ProjectiveIcpConfig(iters=(3, 3), inner_iters=2, samples=768,
                          min_samples=192)


def _trajectory(n=7):
    scene = synthetic.default_scene(seed=3)
    return synthetic.render_trajectory(
        INTR, n, scene=scene, seed=1, step_scale=0.01
    )


class TestIntegrateEvery:
    def test_cadence_counts_fused_frames(self):
        """Static camera, N=2: of seed + 6 tracked frames, exactly the
        seed and tracked frames at counter 2, 4, 6 fuse -> the max voxel
        weight equals 4 (vs 7 for the N=1 control)."""
        depths, _ = _trajectory(2)
        static = [depths[0]] * 7
        w_max = {}
        for n in (1, 2):
            tr = TsdfTracker(INTR, volume=CFG._replace(integrate_every=n),
                             icp=ICP)
            for i, d in enumerate(static):
                assert tr.process(d, float(i)).success
            w_max[n] = float(np.asarray(tr.tsdf_volume.weight).max())
        assert w_max[1] == 7.0
        assert w_max[2] == 4.0  # seed + frames 2, 4, 6

    def test_pose_still_updates_on_skipped_frames(self):
        depths, gt = _trajectory(7)
        tr = TsdfTracker(INTR, volume=CFG._replace(integrate_every=3),
                         icp=ICP)
        poses = []
        for i, d in enumerate(depths):
            r = tr.process(d, float(i))
            assert r.success
            poses.append(np.asarray(r.pose))
        # Every frame (fused or not) got a fresh pose estimate.
        for a, b in zip(poses[1:], poses[:-1]):
            assert not np.allclose(a, b)

    def test_drift_holds_at_n2(self):
        depths, gt = _trajectory(7)
        errs = {}
        for n in (1, 2):
            tr = TsdfTracker(INTR, volume=CFG._replace(integrate_every=n),
                             icp=ICP)
            for i, d in enumerate(depths):
                assert tr.process(d, float(i)).success
            gt_np = np.asarray(gt)
            rel_gt = np.linalg.inv(gt_np[0]) @ gt_np[-1]
            errs[n] = np.linalg.norm(
                np.asarray(tr.pose)[:3, 3] - rel_gt[:3, 3]
            )
        # Decimated fusion tracks against an up-to-1-frame-stale render;
        # at this motion scale the drift stays in the same band.
        assert errs[2] < max(2.0 * errs[1], 0.03), (
            f"N=2 drift {errs[2]:.4f} vs N=1 {errs[1]:.4f}"
        )

    def test_window_matches_per_frame(self):
        """The cadence must be identical through chunk boundaries: a
        5-frame stream in windows of 3 fuses the same frames as per-frame
        processing (bit-identical volumes and poses)."""
        depths, _ = _trajectory(6)
        cfg = CFG._replace(integrate_every=3)
        a = TsdfTracker(INTR, volume=cfg, icp=ICP)
        b = TsdfTracker(INTR, volume=cfg, icp=ICP)
        ra = [a.process(d, float(i)) for i, d in enumerate(depths)]
        rb = b.process_window(depths, [float(i) for i in range(6)],
                              window=3)
        for x, y in zip(ra, rb):
            assert x.success == y.success
            np.testing.assert_allclose(x.pose, y.pose, atol=1e-6)
        np.testing.assert_allclose(
            np.asarray(a.tsdf_volume.weight),
            np.asarray(b.tsdf_volume.weight), atol=0,
        )

    def test_streams_match_tracker(self):
        """The vmapped multi-stream step keys its cadence on the per-slot
        frame counter with the same phase as the tracker (both read 1 at
        the first tracked frame), so fused maps agree."""
        from realsensetracker_tpu.parallel import streams

        depths, _ = _trajectory(5)
        cfg = CFG._replace(integrate_every=2)
        state = streams.init_tsdf_streams(
            jnp.asarray(depths[0])[None], INTR, cfg
        )
        for f in range(1, 5):
            state, _res = streams.step_tsdf_streams(
                state, jnp.asarray(depths[f])[None], INTR, cfg, ICP
            )
        tr = TsdfTracker(INTR, volume=cfg, icp=ICP)
        for f in range(5):
            assert tr.process(depths[f], float(f)).success
        np.testing.assert_allclose(
            np.asarray(state.volume.weight[0]),
            np.asarray(tr.tsdf_volume.weight), atol=0,
        )
        np.testing.assert_allclose(
            np.asarray(state.poses[0]), np.asarray(tr.pose), atol=1e-5
        )

    def test_masked_streams_hold_volume_on_skipped_frames(self):
        from realsensetracker_tpu.parallel import streams

        depths, _ = _trajectory(4)
        cfg = CFG._replace(integrate_every=2)
        state = streams.blank_tsdf_streams(INTR, cfg, num_streams=1)
        on = jnp.ones((1,), bool)
        off = jnp.zeros((1,), bool)
        weights = []
        for f in range(4):
            state, _ = streams.step_tsdf_streams_masked(
                state, jnp.asarray(depths[f])[None], on,
                on if f == 0 else off, INTR, cfg, ICP,
            )
            weights.append(float(np.asarray(state.volume.weight[0]).max()))
        # seed (count 0->1), frame 1 (count 1, odd: skip), frame 2
        # (count 2: fuse), frame 3 (count 3: skip).
        assert weights == [1.0, 1.0, 2.0, 2.0]

    def test_reseed_restarts_cadence(self):
        depths, _ = _trajectory(2)
        static = [depths[0]] * 3
        tr = TsdfTracker(INTR, volume=CFG._replace(integrate_every=2),
                         icp=ICP)
        for i, d in enumerate(static):
            tr.process(d, float(i))
        tr.reseed(static[0])
        for i, d in enumerate(static):
            assert tr.process(d, float(3 + i)).success
        # Post-reseed: seed + frame at counter 2 fused = weight 2.
        assert float(np.asarray(tr.tsdf_volume.weight).max()) == 2.0
