"""Reduced-resolution frame-to-model tracking (TsdfConfig.track_scale).

track_scale=s renders the model and runs the ICP at (H/s, W/s) -- the
raycast gather bill, the tracked step's dominant cost, drops ~s^2-fold -- while the
FULL-resolution frame still integrates, so the fused map is unchanged.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from realsensetracker_tpu.align.projective import ProjectiveIcpConfig
from realsensetracker_tpu.data import synthetic
from realsensetracker_tpu.geometry import camera
from realsensetracker_tpu.mapping import tsdf
from realsensetracker_tpu.tracking.tsdf_tracker import TsdfTracker

# 160x120 so the tracking resolution at scale 2 is the proven 80x60
# test scale (the 40x30 one level below carries too few planes for a
# reliable 6-DOF solve on the sphere scene).
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


def _trajectory(n=6):
    scene = synthetic.default_scene(seed=3)
    return synthetic.render_trajectory(
        INTR, n, scene=scene, seed=1, step_scale=0.01
    )


class TestTrackScale:
    def test_tracks_at_half_resolution(self):
        depths, gt = _trajectory(6)
        tr = TsdfTracker(INTR, volume=CFG._replace(track_scale=2), icp=ICP)
        for i in range(6):
            res = tr.process(depths[i], float(i))
            assert res.success, f"frame {i} lost tracking"
        gt = np.asarray(gt)
        rel_gt = np.linalg.inv(gt[0]) @ gt[5]
        err = np.linalg.norm(np.asarray(tr.pose)[:3, 3] - rel_gt[:3, 3])
        # Half-res tracking trades a little accuracy for the ~4x gather
        # cut at this tiny 160x120 / 10 cm-voxel test scale (measured
        # ~0.020 vs <0.02 full-res; same budget the coarse-raycast test
        # grants in tests/test_tsdf.py).
        assert err < 0.035, f"ATE {err:.4f} m"

    def test_integration_stays_full_resolution(self):
        """The fused volume must come from FULL-res frames: on a static
        camera (registration ~identity at either scale) the track_scale=2
        volume matches the full-res volume closely -- a half-res
        integration would observe ~4x fewer pixels and diverge."""
        depths, _ = _trajectory(3)
        static = [depths[0]] * 3
        vols = []
        for s in (1, 2):
            tr = TsdfTracker(INTR, volume=CFG._replace(track_scale=s),
                             icp=ICP)
            for i, d in enumerate(static):
                assert tr.process(d, float(i)).success
            vols.append(tr.tsdf_volume)
        w1 = np.asarray(vols[0].weight)
        w2 = np.asarray(vols[1].weight)
        # Same voxels observed, nearly identical weights (poses differ
        # only by sub-voxel registration noise on identical frames).
        assert np.mean((w1 > 0) == (w2 > 0)) > 0.999
        diff = np.abs(np.asarray(vols[1].tsdf) - np.asarray(vols[0].tsdf))
        # A handful of truncation-boundary voxels flip sign under the
        # sub-voxel registration noise; everything else matches tightly.
        assert np.mean(diff < 0.05) > 0.999
        assert np.mean(diff) < 1e-3

    def test_window_matches_per_frame(self):
        depths, _ = _trajectory(5)
        cfg = CFG._replace(track_scale=2)
        a = TsdfTracker(INTR, volume=cfg, icp=ICP)
        b = TsdfTracker(INTR, volume=cfg, icp=ICP)
        ra = [a.process(d, float(i)) for i, d in enumerate(depths)]
        rb = b.process_window(depths, [float(i) for i in range(5)],
                              window=4)
        for x, y in zip(ra, rb):
            assert x.success == y.success
            np.testing.assert_allclose(x.pose, y.pose, atol=1e-6)

    def test_non_power_of_two_raises(self):
        tr = TsdfTracker(INTR, volume=CFG._replace(track_scale=3), icp=ICP)
        depths, _ = _trajectory(2)
        tr.process(depths[0], 0.0)  # seed integrates full-res: no check
        with pytest.raises(ValueError, match="power of 2"):
            tr.process(depths[1], 1.0)

    def test_masked_streams_honor_track_scale(self):
        """The batched-serving step (step_tsdf_streams_masked) must apply
        TsdfConfig.track_scale exactly like the single-stream tracker --
        review finding: it previously rendered/registered at full
        resolution, silently ignoring the knob."""
        from realsensetracker_tpu.parallel import streams

        depths, _ = _trajectory(4)
        cfg = CFG._replace(track_scale=2)
        state = streams.blank_tsdf_streams(INTR, cfg, num_streams=1)
        on = jnp.ones((1,), bool)
        for f in range(4):
            state, stats = streams.step_tsdf_streams_masked(
                state, jnp.asarray(depths[f])[None], on,
                on if f == 0 else jnp.zeros((1,), bool),
                INTR, cfg, ICP,
            )
        tr = TsdfTracker(INTR, volume=cfg, icp=ICP)
        for f in range(4):
            assert tr.process(depths[f], float(f)).success
        np.testing.assert_allclose(
            np.asarray(state.poses[0]), np.asarray(tr.pose), atol=1e-5
        )

    def test_track_cov_diagnostic_reported(self):
        """Every frame's stats row carries the constraint-coverage
        diagnostic (valid render px / valid frame px at the tracking
        resolution) in [0, ~1+eps]."""
        from realsensetracker_tpu.tracking import tsdf_tracker as tt

        depths, _ = _trajectory(3)
        tr = TsdfTracker(INTR, volume=CFG._replace(track_scale=2), icp=ICP)
        tr.process(depths[0], 0.0)
        out = tt._fused_tsdf_step(
            tr._vol, jnp.asarray(depths[1], jnp.float32), tr._pose,
            intr=INTR, vol_cfg=tr._track_cfg, icp_cfg=ICP,
            min_inlier_fraction=0.2,
        )
        s = np.asarray(out.stats)
        assert s.shape == (tt.TSDF_STATS_WIDTH,)
        assert 0.0 <= s[19] <= 1.5
        assert s[20] in (0.0, 1.0)

    def test_photometric_smoke(self):
        """Joint geo+photo registration also runs at the tracking
        resolution (grays mean-pool; the gray CARRY stays full-res)."""
        from realsensetracker_tpu.align.rgbd import RgbdIcpConfig

        depths, _ = _trajectory(4)
        grays = [np.asarray(jnp.clip(d / 5.0, 0.0, 1.0)) for d in depths]
        colors = [np.repeat(g[..., None], 3, axis=-1) for g in grays]
        tr = TsdfTracker(
            INTR, volume=CFG._replace(track_scale=2),
            icp=ICP, use_color=True,
            photometric=RgbdIcpConfig(iters=(3, 3), samples=768,
                                      min_samples=192),
        )
        for i in range(4):
            res = tr.process(depths[i], float(i), color=colors[i])
            assert res.success, f"frame {i} lost tracking"
        # The carried photometric reference stays FULL resolution.
        assert tuple(tr._prev_gray.shape) == (H, W)


class TestTrackScaleFallback:
    """track_scale auto-fallback (TsdfTracker.track_scale_fallback).

    The degradation scene: ONLY small spheres (~20 full-res px across)
    with nothing else in sensor range. At track_scale=4 the c2f raycast's
    coarse phase runs on an 8x10 grid whose rays are 64 full-res px
    apart, so most spheres get no coarse hit and vanish from the render
    entirely -- constraint coverage collapses (measured 0.41 vs 0.74 at
    full res) and the solve starves. The coverage diagnostic catches it
    and drops the tracker back to full-resolution registration."""

    W2, H2 = 160, 128  # height divisible by track_scale * raycast_coarse
    INTR2 = camera.Intrinsics(fx=128.0, fy=128.0, cx=(W2 - 1) / 2,
                              cy=(H2 - 1) / 2, width=W2, height=H2)
    CFG2 = CFG._replace(raycast_coarse=4, refine_steps=8)

    @classmethod
    def _thin_frames(cls, n=7):
        rng = np.random.RandomState(5)
        centers = []
        for gx in (-1.0, -0.33, 0.33, 1.0):
            for gy in (-0.6, 0.0, 0.6):
                centers.append([gx + rng.uniform(-0.08, 0.08),
                                gy + rng.uniform(-0.08, 0.08),
                                rng.uniform(1.7, 2.5)])
        scene = synthetic.Scene(
            sphere_centers=jnp.asarray(centers, jnp.float32),
            sphere_radii=jnp.full((len(centers),), 0.16, jnp.float32),
            floor_y=100.0, wall_z=50.0,  # out of sensor range
        )
        poses = synthetic.render_trajectory(
            cls.INTR2, n, scene=scene, seed=1, step_scale=0.006
        )[1]
        frames = []
        for p in np.asarray(poses):
            d = np.array(synthetic.render_depth(
                cls.INTR2, jnp.asarray(p, jnp.float32), scene
            ))
            d[d > 4.0] = 0.0  # sensor range clip
            frames.append(d)
        return frames

    def _run(self, track_scale, fallback, frames):
        tr = TsdfTracker(
            self.INTR2, volume=self.CFG2._replace(track_scale=track_scale),
            icp=ICP, min_inlier_fraction=0.05,
            track_scale_fallback=fallback, fallback_patience=2,
        )
        oks = [tr.process(f, float(i)).success
               for i, f in enumerate(frames)]
        return tr, oks

    def test_reduced_res_degrades_without_fallback(self):
        frames = self._thin_frames()
        tr, oks = self._run(4, 0.0, frames)
        assert not any(oks[1:]), "scene no longer degrades at scale 4"
        assert tr.track_scale_active == 4

    def test_fallback_triggers_and_recovers(self):
        frames = self._thin_frames()
        tr, oks = self._run(4, 0.6, frames)
        assert tr.num_track_scale_fallbacks == 1
        assert tr.track_scale_active == 1
        # Patience is 2 failed-coverage frames; everything after the
        # switch tracks again at full resolution.
        assert all(oks[3:]), f"no recovery after fallback: {oks}"

    def test_healthy_scene_keeps_reduced_res(self):
        depths, _ = _trajectory(6)
        tr = TsdfTracker(INTR, volume=CFG._replace(track_scale=2), icp=ICP,
                         track_scale_fallback=0.3, fallback_patience=2)
        for i, d in enumerate(depths):
            assert tr.process(d, float(i)).success
        assert tr.num_track_scale_fallbacks == 0
        assert tr.track_scale_active == 2

    def test_reseed_rearms_reduced_res(self):
        frames = self._thin_frames()
        tr, _ = self._run(4, 0.6, frames)
        assert tr.track_scale_active == 1
        tr.reseed(frames[0])
        assert tr.track_scale_active == 4
