"""Projective point-to-plane ICP on synthetic raycast frames: BASELINE
config 1 (single-pair registration, CPU-runnable)."""

import jax.numpy as jnp
import numpy as np
import pytest

from realsensetracker_tpu.align import projective
from realsensetracker_tpu.data import synthetic
from realsensetracker_tpu.geometry import camera, se3
from realsensetracker_tpu.ops import pyramid

INTR = camera.Intrinsics(fx=160.0, fy=160.0, cx=79.5, cy=59.5, width=160, height=120)


def _register(motion, cfg=None, intr=INTR):
    d0, d1, T_true = synthetic.render_pair(intr, jnp.asarray(motion, jnp.float32))
    src_levels, intrs = pyramid.build_pyramid(d1, intr, num_levels=3)
    dst_levels, _ = pyramid.build_pyramid(d0, intr, num_levels=3)
    cfg = cfg or projective.ProjectiveIcpConfig(iters=(6, 6, 10), samples=2048)
    res = projective.projective_icp(src_levels, dst_levels, tuple(intrs), cfg=cfg)
    return res, T_true


def _pose_err(T_est, T_true):
    delta = se3.compose(se3.inverse(T_true), T_est)
    tw = np.asarray(se3.log(delta))
    return np.abs(tw[:3]).max(), np.abs(tw[3:]).max()


class TestPyramid:
    def test_levels_shapes(self):
        d0, _, _ = synthetic.render_pair(INTR, jnp.zeros(6))
        levels, intrs = pyramid.build_pyramid(d0, INTR, num_levels=3)
        assert levels[0].vertex_map.shape == (120, 160, 3)
        assert levels[1].vertex_map.shape == (60, 80, 3)
        assert levels[2].vertex_map.shape == (30, 40, 3)
        assert intrs[1].fx == pytest.approx(80.0)

    def test_downsample_validity(self):
        depth = jnp.array([[1.0, 0.0], [0.0, 0.0]])
        valid = depth > 0
        d, v = pyramid.downsample_depth(depth, valid)
        assert bool(v[0, 0])
        assert float(d[0, 0]) == pytest.approx(1.0)

    def test_grid_normals_against_scene(self):
        # Flat wall at z=4 fills the image center: normals should be -z.
        scene = synthetic.Scene(
            sphere_centers=jnp.zeros((1, 3)) + 100.0, sphere_radii=jnp.ones(1) * 0.01,
            floor_y=100.0, wall_z=4.0,
        )
        d = synthetic.render_depth(INTR, se3.identity(), scene)
        levels, _ = pyramid.build_pyramid(d, INTR, num_levels=1)
        n = np.asarray(levels[0].normal_map[40:80, 40:120])
        ok = np.asarray(levels[0].valid[40:80, 40:120])
        assert ok.mean() > 0.9
        np.testing.assert_allclose(n[ok], np.tile([0, 0, -1.0], (ok.sum(), 1)), atol=1e-3)


class TestProjectiveIcp:
    def test_identity_motion(self):
        res, _ = _register(np.zeros(6))
        t_err, r_err = _pose_err(res.transform, se3.identity())
        assert t_err < 1e-4 and r_err < 1e-4
        assert float(res.inlier_fraction) > 0.5

    def test_small_translation(self):
        res, T_true = _register([0.02, -0.01, 0.015, 0, 0, 0])
        t_err, r_err = _pose_err(res.transform, T_true)
        assert t_err < 2e-3 and r_err < 2e-3

    def test_small_rotation(self):
        res, T_true = _register([0, 0, 0, 0.02, -0.015, 0.01])
        t_err, r_err = _pose_err(res.transform, T_true)
        assert t_err < 2e-3 and r_err < 2e-3

    def test_combined_motion(self):
        res, T_true = _register([0.03, 0.01, -0.02, 0.02, 0.01, -0.02])
        t_err, r_err = _pose_err(res.transform, T_true)
        assert t_err < 3e-3 and r_err < 3e-3

    def test_flagship_schedule_robust_to_degraded_depth(self):
        """The (3,3,2) x 2-inner flagship schedule must hold accuracy on
        sensor-realistic degradation: 30% random dropout + 5 mm noise on
        BOTH frames (guards the outer/inner split against regression)."""
        rng = np.random.RandomState(11)
        motion = [0.02, -0.01, 0.015, 0.01, -0.015, 0.01]
        d0, d1, T_true = synthetic.render_pair(INTR, jnp.asarray(motion, jnp.float32))

        def degrade(d, seed):
            r = np.random.RandomState(seed)
            arr = np.asarray(d)
            arr = arr + 0.005 * r.randn(*arr.shape).astype(np.float32)
            arr[r.rand(*arr.shape) < 0.3] = 0.0  # dropout -> invalid
            return jnp.asarray(arr)

        del rng
        res = projective.register_depth_pair(
            degrade(d1, 1), degrade(d0, 2), INTR,
            projective.ProjectiveIcpConfig(),  # flagship defaults
        )
        t_err, r_err = _pose_err(res.transform, T_true)
        assert t_err < 5e-3 and r_err < 5e-3
        # 30% dropout also kills the 4 neighbors' normals on the
        # destination (valid ~ 0.7^5), so ~0.12 matched is expected.
        assert float(res.inlier_fraction) > 0.05

    def test_inner_iters_matches_reassociate_accuracy(self):
        """(3,3,2) x 2 must match (6,5,4) x 1 accuracy on clean frames."""
        motion = [0.03, 0.01, -0.02, 0.02, 0.01, -0.02]
        d0, d1, T_true = synthetic.render_pair(INTR, jnp.asarray(motion, jnp.float32))
        res_a = projective.register_depth_pair(
            d1, d0, INTR,
            projective.ProjectiveIcpConfig(iters=(6, 5, 4), inner_iters=1),
        )
        res_b = projective.register_depth_pair(
            d1, d0, INTR,
            projective.ProjectiveIcpConfig(iters=(3, 3, 2), inner_iters=2),
        )
        ta, ra = _pose_err(res_a.transform, T_true)
        tb, rb = _pose_err(res_b.transform, T_true)
        assert tb < max(2 * ta, 1e-3) and rb < max(2 * ra, 1e-3)

    def test_result_finite_on_empty_frames(self):
        # All-invalid depth must not produce NaNs (rank-deficient H guard).
        d = jnp.zeros((120, 160))
        levels, intrs = pyramid.build_pyramid(d, INTR, num_levels=3)
        res = projective.projective_icp(
            levels, levels, tuple(intrs),
            cfg=projective.ProjectiveIcpConfig(iters=(2, 2, 2), samples=512),
        )
        assert np.all(np.isfinite(np.asarray(res.transform)))
        np.testing.assert_allclose(np.asarray(res.transform), np.eye(4), atol=1e-5)


class TestNormalSpaceSampling:
    def test_bins_are_balanced_on_box_scene(self):
        # Wall + floor scene: stride sampling is wall-dominated; normal-space
        # sampling must allocate a fair share to the floor orientation.
        scene = synthetic.Scene(
            sphere_centers=jnp.full((1, 3), 100.0),
            sphere_radii=jnp.full((1,), 0.01),
            floor_y=0.8, wall_z=3.0,
        )
        d = synthetic.render_depth(INTR, se3.identity(), scene)
        levels, _ = pyramid.build_pyramid(d, INTR, 1)
        pts, nrm, ok = projective.sample_level_normal_space(levels[0], 1200)
        okn = np.asarray(ok)
        n = np.asarray(nrm)[okn]
        floorish = (np.abs(n[:, 1]) > 0.9).mean()
        wallish = (np.abs(n[:, 2]) > 0.9).mean()
        assert floorish > 0.2 and wallish > 0.2  # both orientations present
        # Two-plane scene populates 2 of 6 orientation bins: ~1/3 of the
        # fixed-capacity slots carry valid samples.
        assert okn.mean() > 0.25

    def test_normal_space_config_registers(self):
        cfg = projective.ProjectiveIcpConfig(
            iters=(6, 6, 8), samples=1536, sample_mode="normal_space"
        )
        res, T_true = _register([0.02, -0.01, 0.01, 0.01, -0.01, 0.01], cfg=cfg)
        t_err, r_err = _pose_err(res.transform, T_true)
        assert t_err < 1e-2 and r_err < 1e-2

    def _level_from_normals(self, normals):
        h, w, _ = normals.shape
        vmap = jnp.arange(h * w * 3, dtype=jnp.float32).reshape(h, w, 3)
        valid = jnp.ones((h, w), bool)
        return pyramid.PyramidLevel(
            vertex_map=vmap, normal_map=jnp.asarray(normals, jnp.float32),
            valid=valid, vertex_valid=valid, packed=None,
        )

    def test_rare_tail_bin_is_kept(self):
        """A fully-valid frame whose rarest orientation bin sits at the END
        of the argsort order: the clamped slice used to keep earlier-bin
        points and DROP the rare bin's own entry -- exactly the one
        constraint direction normal-space sampling exists to preserve."""
        n = np.tile(np.array([1.0, 0.0, 0.0], np.float32), (8, 8, 1))
        n[7, 7] = [0.0, 0.0, -1.0]  # one -z pixel: bin 5, last segment
        level = self._level_from_normals(n)
        _, nrm, ok = projective.sample_level_normal_space(level, 12)
        kept = np.asarray(nrm)[np.asarray(ok)]
        assert (kept[:, 2] < -0.9).sum() == 1, "rare -z sample was dropped"

    def test_no_duplicate_picks_from_remainder(self):
        """count % bins != 0: the remainder must come from extra per-bin
        slots, not a shared order[:rem] slice that double-weights bin 0's
        head samples in the GN system."""
        n = np.zeros((8, 8, 3), np.float32)
        n[:4] = [1.0, 0.0, 0.0]   # 32 pixels of +x (bin 0)
        n[4:] = [0.0, 0.0, -1.0]  # 32 pixels of -z (bin 5)
        level = self._level_from_normals(n)
        pts, _, ok = projective.sample_level_normal_space(level, 8)  # rem=2
        kept = np.asarray(pts)[np.asarray(ok)]
        assert len(kept) == len(np.unique(kept[:, 0]))  # vertex ids unique
        assert len(kept) >= 3  # both bins represented plus remainder slots


class TestSampledSourceFastPath:
    def test_sample_depth_points_matches_sample_level(self):
        d0, _, _ = synthetic.render_pair(INTR, jnp.zeros(6))
        levels, intrs = pyramid.build_pyramid(d0, INTR, 1, with_normals=False)
        pts_a, _, ok_a = projective.sample_level(levels[0], 1024)
        pts_b, ok_b = projective.sample_depth_points(
            jnp.where((d0 > 0.05) & (d0 < 10.0), d0, 0.0), INTR, 1024
        )
        np.testing.assert_array_equal(np.asarray(ok_a), np.asarray(ok_b))
        np.testing.assert_allclose(np.asarray(pts_a), np.asarray(pts_b), atol=1e-6)

    def test_fast_path_matches_pyramid_path(self):
        d0, d1, _ = synthetic.render_pair(INTR, jnp.asarray([0.01, 0, 0.01, 0, 0.01, 0]))
        cfg = projective.ProjectiveIcpConfig(iters=(4, 4, 4), samples=1024)
        res_fast = projective.register_depth_pair(d1, d0, INTR, cfg)
        # Pyramid path: same stride sampling through full source levels.
        src_l, intrs = pyramid.build_pyramid(d1, INTR, 3, with_normals=False)
        dst_l, _ = pyramid.build_pyramid(d0, INTR, 3)
        res_pyr = projective.projective_icp(src_l, dst_l, tuple(intrs), cfg=cfg)
        np.testing.assert_allclose(
            np.asarray(res_fast.transform), np.asarray(res_pyr.transform), atol=1e-5
        )


class TestFitLevels:
    """Resolution-aware schedule: fit_levels drops coarse
    pyramid levels whose smaller dimension would fall below ~24 px."""

    def test_vga_default_unchanged(self):
        cfg = projective.ProjectiveIcpConfig()
        assert projective.fit_levels(cfg, 480, 640) is cfg

    def test_tiny_resolution_truncates_keeping_fine_tail(self):
        cfg = projective.ProjectiveIcpConfig(iters=(5, 4, 3, 2))
        fit = projective.fit_levels(cfg, 60, 80)
        # 60 >> 1 = 30 >= 24, 60 >> 2 = 15 < 24: two usable levels; the
        # iters tuple is coarse -> fine, so the FINE tail survives.
        assert fit.iters == (3, 2)
        # Non-level fields untouched.
        assert fit._replace(iters=cfg.iters) == cfg

    def test_already_short_schedule_unchanged(self):
        cfg = projective.ProjectiveIcpConfig(iters=(3, 3))
        assert projective.fit_levels(cfg, 60, 80) is cfg

    def test_single_level_floor(self):
        cfg = projective.ProjectiveIcpConfig(iters=(3, 3, 3, 2))
        fit = projective.fit_levels(cfg, 16, 16)
        assert fit.iters == (2,)  # never truncates to zero levels

    def test_register_depth_pair_default_cfg_small_frames(self):
        # The default 4-level schedule at 80x60 previously built a 10x7
        # coarsest level; now it auto-truncates and still converges.
        intr = camera.Intrinsics(fx=64.0, fy=64.0, cx=39.5, cy=29.5,
                                 width=80, height=60)
        d0, d1, T_true = synthetic.render_pair(
            intr, jnp.asarray([0.01, 0, 0.01, 0, 0.005, 0], jnp.float32)
        )
        res = projective.register_depth_pair(d1, d0, intr)
        t_err, r_err = _pose_err(res.transform, T_true)
        # 80x60 depth is coarse; convergence (mm-scale), not parity.
        assert t_err < 5e-3 and r_err < 2e-3
