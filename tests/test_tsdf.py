"""TSDF volume fusion + raycast frame-to-model tracking (mapping/tsdf.py,
tracking/tsdf_tracker.py).

Geometry oracle: the analytic synthetic renderer (data/synthetic.py) --
a wall at known z gives exact expected depths/signed distances, and
rendered trajectories carry exact ground-truth poses.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from realsensetracker_tpu.data import synthetic
from realsensetracker_tpu.geometry import camera, se3
from realsensetracker_tpu.mapping import tsdf

W, H = 80, 60
INTR = camera.Intrinsics(
    fx=64.0, fy=64.0, cx=(W - 1) / 2, cy=(H - 1) / 2, width=W, height=H
)

# Wall-only scene: a plane at z = WALL_Z, floor pushed out of range.
WALL_Z = 3.0
WALL_SCENE = synthetic.Scene(
    sphere_centers=jnp.zeros((0, 3), jnp.float32),
    sphere_radii=jnp.zeros((0,), jnp.float32),
    floor_y=100.0,
    wall_z=WALL_Z,
)

CFG = tsdf.TsdfConfig(
    resolution=64,
    voxel_size=0.1,
    origin=(-3.2, -2.4, -0.3),
    trunc=0.3,
    max_range=5.0,
)


def _wall_depth(pose=None):
    pose = se3.identity() if pose is None else pose
    return synthetic.render_depth(INTR, pose, WALL_SCENE)


def _voxel_index(cfg, p):
    return tuple(
        int(round((p[a] - cfg.origin[a]) / cfg.voxel_size - 0.5))
        for a in range(3)
    )


class TestIntegrate:
    def test_wall_signs(self):
        """After fusing one wall frame: free space in front of the wall is
        positive, the truncation band straddles zero, behind-the-band
        voxels stay unobserved."""
        vol = tsdf.integrate(
            tsdf.init_volume(CFG), _wall_depth(), se3.identity(), INTR, CFG
        )
        t = np.asarray(vol.tsdf)
        w = np.asarray(vol.weight)

        ix, iy, iz = _voxel_index(CFG, (0.0, 0.0, 2.0))  # 1 m in front
        assert w[ix, iy, iz] > 0
        assert t[ix, iy, iz] == pytest.approx(1.0)

        ix, iy, iz = _voxel_index(CFG, (0.0, 0.0, WALL_Z - 0.15))  # band -
        assert w[ix, iy, iz] > 0
        assert 0.0 < t[ix, iy, iz] < 1.0

        ix, iy, iz = _voxel_index(CFG, (0.0, 0.0, WALL_Z + 0.15))  # band +
        assert w[ix, iy, iz] > 0
        assert -1.0 < t[ix, iy, iz] < 0.0

        ix, iy, iz = _voxel_index(CFG, (0.0, 0.0, WALL_Z + 1.0))  # occluded
        assert w[ix, iy, iz] == 0
        assert t[ix, iy, iz] == pytest.approx(1.0)

    def test_zero_crossing_at_wall(self):
        """The sign change along +z happens at the wall plane (within one
        voxel)."""
        vol = tsdf.integrate(
            tsdf.init_volume(CFG), _wall_depth(), se3.identity(), INTR, CFG
        )
        t = np.asarray(vol.tsdf)
        ix, iy, _ = _voxel_index(CFG, (0.0, 0.0, WALL_Z))
        line = t[ix, iy, :]
        zc = CFG.origin[2] + (np.arange(CFG.resolution) + 0.5) * CFG.voxel_size
        neg = np.where(line < 0)[0]
        assert neg.size > 0
        first_neg = neg[0]
        assert abs(zc[first_neg] - WALL_Z) < CFG.voxel_size + 1e-6

    def test_repeat_integration_converges(self):
        """Fusing the same frame twice leaves tsdf unchanged (running
        average of identical observations) and doubles the weight up to
        the cap."""
        v1 = tsdf.integrate(
            tsdf.init_volume(CFG), _wall_depth(), se3.identity(), INTR, CFG
        )
        v2 = tsdf.integrate(v1, _wall_depth(), se3.identity(), INTR, CFG)
        np.testing.assert_allclose(
            np.asarray(v2.tsdf), np.asarray(v1.tsdf), atol=1e-6
        )
        np.testing.assert_allclose(
            np.asarray(v2.weight), np.minimum(
                2 * np.asarray(v1.weight), CFG.max_weight
            ), atol=1e-6,
        )


class TestRaycast:
    def test_wall_roundtrip(self):
        vol = tsdf.integrate(
            tsdf.init_volume(CFG), _wall_depth(), se3.identity(), INTR, CFG
        )
        d = np.asarray(tsdf.raycast(vol, se3.identity(), INTR, CFG))
        center = d[H // 4 : 3 * H // 4, W // 4 : 3 * W // 4]
        assert (center > 0).all()  # every central ray hits
        # Interpolated crossing on a nearest-sampled grid: errors bounded
        # by ~1 voxel; central rays are near-axial so much tighter.
        assert np.abs(center - WALL_Z).max() < CFG.voxel_size

    def test_miss_is_zero(self):
        """Rays through unobserved space return 0 (invalid-depth code)."""
        vol = tsdf.init_volume(CFG)
        d = np.asarray(tsdf.raycast(vol, se3.identity(), INTR, CFG))
        assert (d == 0).all()

    def test_coarse_to_fine_matches_full(self):
        """Coarse-to-fine raycast agrees with the exact full march on
        smooth geometry (the wall), and misses nothing there."""
        vol = tsdf.integrate(
            tsdf.init_volume(CFG), _wall_depth(), se3.identity(), INTR, CFG
        )
        full = np.asarray(tsdf.raycast(vol, se3.identity(), INTR, CFG))
        ctf = np.asarray(tsdf.raycast_coarse_to_fine(
            vol, se3.identity(), INTR, CFG, coarse=4, refine_steps=12
        ))
        center = np.s_[H // 4 : 3 * H // 4, W // 4 : 3 * W // 4]
        assert (ctf[center] > 0).all()
        both = (full > 0) & (ctf > 0)
        # The refine march samples on a shifted z-grid, so interpolated
        # crossings differ by up to ~a sample spacing on the nearest-
        # sampled field -- not bit-identical, but sub-voxel.
        assert np.abs(full[both] - ctf[both]).max() < CFG.voxel_size

    def test_render_dispatch(self):
        """render_model_depth picks the coarse path from the config."""
        vol = tsdf.integrate(
            tsdf.init_volume(CFG), _wall_depth(), se3.identity(), INTR, CFG
        )
        cfg2 = CFG._replace(raycast_coarse=4)
        d = np.asarray(tsdf.render_model_depth(
            vol, se3.identity(), INTR, cfg2
        ))
        ref = np.asarray(tsdf.raycast_coarse_to_fine(
            vol, se3.identity(), INTR, CFG, coarse=4, refine_steps=12
        ))
        np.testing.assert_array_equal(d, ref)

    def test_novel_view(self):
        """Raycast from a pose the volume was NOT integrated from matches
        the analytic render from that pose (the model is world-frame)."""
        vol = tsdf.init_volume(CFG)
        vol = tsdf.integrate(vol, _wall_depth(), se3.identity(), INTR, CFG)
        pose2 = se3.exp(
            jnp.asarray([0.05, -0.03, 0.1, 0.02, -0.015, 0.01], jnp.float32)
        )
        vol = tsdf.integrate(
            vol, _wall_depth(pose2), pose2, INTR, CFG
        )
        pose3 = se3.exp(
            jnp.asarray([0.02, 0.02, 0.05, -0.01, 0.01, 0.0], jnp.float32)
        )
        d = np.asarray(tsdf.raycast(vol, pose3, INTR, CFG))
        ref = np.asarray(_wall_depth(pose3))
        center = np.s_[H // 4 : 3 * H // 4, W // 4 : 3 * W // 4]
        assert (d[center] > 0).all()
        assert np.abs(d[center] - ref[center]).max() < 2 * CFG.voxel_size


class TestExtractSurface:
    def test_wall_surface(self):
        vol = tsdf.integrate(
            tsdf.init_volume(CFG), _wall_depth(), se3.identity(), INTR, CFG
        )
        c = tsdf.extract_surface(vol, CFG, capacity=4096)
        pts = np.asarray(c.points)[np.asarray(c.mask)]
        assert len(pts) > 100
        # Every surface point sits on the wall plane, within a voxel.
        assert np.abs(pts[:, 2] - WALL_Z).max() < CFG.voxel_size

    def test_empty_volume(self):
        c = tsdf.extract_surface(tsdf.init_volume(CFG), CFG, capacity=1024)
        assert not bool(np.asarray(c.mask).any())


class TestColoredTsdf:
    def test_color_fuses_in_band_only(self):
        """A uniform red frame colors the near-surface band; free-space
        voxels keep zero color weight."""
        import jax.numpy as jnp

        red = jnp.zeros((H, W, 3), jnp.float32).at[..., 0].set(1.0)
        vol = tsdf.integrate(
            tsdf.init_volume(CFG, with_color=True), _wall_depth(),
            se3.identity(), INTR, CFG, color=red,
        )
        cw = np.asarray(vol.color_weight)
        col = np.asarray(vol.color)
        ix, iy, iz = _voxel_index(CFG, (0.0, 0.0, WALL_Z - 0.15))  # band
        assert cw[ix, iy, iz] > 0
        np.testing.assert_allclose(col[ix, iy, iz], [1, 0, 0], atol=1e-6)
        ix, iy, iz = _voxel_index(CFG, (0.0, 0.0, 1.0))  # free space
        assert cw[ix, iy, iz] == 0

    def test_color_mismatch_raises(self):
        with pytest.raises(ValueError, match="color"):
            tsdf.integrate(
                tsdf.init_volume(CFG, with_color=True), _wall_depth(),
                se3.identity(), INTR, CFG,
            )
        with pytest.raises(ValueError, match="color"):
            tsdf.integrate(
                tsdf.init_volume(CFG), _wall_depth(),
                se3.identity(), INTR, CFG,
                color=np.zeros((H, W, 3), np.float32),
            )

    def test_colored_surface_extraction(self):
        import jax.numpy as jnp

        green = jnp.zeros((H, W, 3), jnp.float32).at[..., 1].set(0.8)
        vol = tsdf.integrate(
            tsdf.init_volume(CFG, with_color=True), _wall_depth(),
            se3.identity(), INTR, CFG, color=green,
        )
        c, cols = tsdf.extract_surface_colored(vol, CFG, capacity=2048)
        mask = np.asarray(c.mask)
        assert mask.sum() > 100
        got = np.asarray(cols)[mask]
        np.testing.assert_allclose(
            got, np.tile([0.0, 0.8, 0.0], (len(got), 1)), atol=1e-5
        )
        # Plain extraction still works on a colored volume.
        plain = tsdf.extract_surface(vol, CFG, capacity=2048)
        assert np.asarray(plain.mask).sum() == mask.sum()

    def test_tracker_colored_map(self):
        from realsensetracker_tpu.align.projective import ProjectiveIcpConfig
        from realsensetracker_tpu.tracking.tsdf_tracker import TsdfTracker

        scene = synthetic.default_scene(seed=3)
        depths, colors, _ = synthetic.render_trajectory_rgbd(
            INTR, 3, scene=scene, seed=1, step_scale=0.01
        )
        tr = TsdfTracker(
            INTR, volume=CFG,
            icp=ProjectiveIcpConfig(iters=(3, 3), inner_iters=2,
                                    samples=768, min_samples=192),
            use_color=True,
        )
        for i in range(3):
            res = tr.process(depths[i], float(i), color=colors[i])
            assert res.success
        cm = tr.world_map_colored
        assert cm is not None
        c, cols = cm
        mask = np.asarray(c.mask)
        assert mask.sum() > 100
        got = np.asarray(cols)[mask]
        assert (got >= 0).all() and (got <= 1).all()
        assert got.std() > 0.01  # a real scene is not uniformly colored

    def test_tracker_color_required(self):
        from realsensetracker_tpu.tracking.tsdf_tracker import TsdfTracker

        tr = TsdfTracker(INTR, volume=CFG, use_color=True)
        with pytest.raises(ValueError, match="color"):
            tr.process(np.asarray(_wall_depth()), 0.0)


class TestTsdfTracker:
    def _tracker(self):
        from realsensetracker_tpu.align.projective import ProjectiveIcpConfig
        from realsensetracker_tpu.tracking.tsdf_tracker import TsdfTracker

        icp = ProjectiveIcpConfig(
            iters=(3, 3), inner_iters=2, samples=768, min_samples=192
        )
        return TsdfTracker(INTR, volume=CFG, icp=icp)

    def test_tracks_synthetic_trajectory(self):
        scene = synthetic.default_scene(seed=3)
        depths, gt = synthetic.render_trajectory(
            INTR, 6, scene=scene, seed=1, step_scale=0.01
        )
        tr = self._tracker()
        for i in range(6):
            res = tr.process(depths[i], float(i))
            assert res.success, f"frame {i} lost tracking"
        gt = np.asarray(gt)
        rel_gt = np.linalg.inv(gt[0]) @ gt[5]
        err = np.linalg.norm(
            np.asarray(tr.pose)[:3, 3] - rel_gt[:3, 3]
        )
        assert err < 0.02, f"ATE {err:.4f} m"

    def test_tracks_with_coarse_raycast(self):
        """The tracker holds accuracy with the coarse-to-fine render."""
        scene = synthetic.default_scene(seed=3)
        depths, gt = synthetic.render_trajectory(
            INTR, 5, scene=scene, seed=1, step_scale=0.01
        )
        tr = self._tracker()
        # coarse=2 at 80x60 (40x30 coarse rays) matches the ray density of
        # coarse=4 at production 640x480 (160x120); coarse=4 here leaves
        # 20x15 rays -- too sparse for the sphere scene's thin structures.
        tr.volume = CFG._replace(raycast_coarse=2)
        for i in range(5):
            res = tr.process(depths[i], float(i))
            assert res.success, f"frame {i} lost tracking"
        gt = np.asarray(gt)
        rel_gt = np.linalg.inv(gt[0]) @ gt[4]
        err = np.linalg.norm(np.asarray(tr.pose)[:3, 3] - rel_gt[:3, 3])
        # The coarse render drops silhouette pixels the exact march keeps,
        # so this variant trades a little accuracy for the gather budget
        # (measured ~2.2 cm vs <2 cm exact at this tiny 80x60 / 10 cm-voxel
        # test scale).
        assert err < 0.035, f"ATE {err:.4f} m"

    def test_world_map_surface(self):
        depths, _ = synthetic.render_trajectory(
            INTR, 3, scene=synthetic.default_scene(seed=3), seed=1,
            step_scale=0.01,
        )
        tr = self._tracker()
        for i in range(3):
            tr.process(depths[i], float(i))
        m = tr.world_map
        pts = np.asarray(m.points)[np.asarray(m.mask)]
        assert len(pts) > 200  # a fused surface exists
        # Surface points live inside the configured volume.
        lo = np.asarray(CFG.origin)
        hi = lo + CFG.resolution * CFG.voxel_size
        assert (pts >= lo - 1e-5).all() and (pts <= hi + 1e-5).all()

    def test_api_tracker_method(self):
        from realsensetracker_tpu.api.config import TrackerConfig
        from realsensetracker_tpu.api.tracker import Tracker
        from realsensetracker_tpu.align.projective import ProjectiveIcpConfig

        depths, _ = synthetic.render_trajectory(
            INTR, 3, scene=synthetic.default_scene(seed=3), seed=1,
            step_scale=0.01,
        )
        t = Tracker(TrackerConfig(
            intrinsics=INTR, method="tsdf", tsdf=CFG,
            projective=ProjectiveIcpConfig(
                iters=(3, 3), inner_iters=2, samples=768, min_samples=192
            ),
        ))
        for i in range(3):
            res = t.process(depths[i], float(i))
            assert res.success
        assert t.world_map is not None
        assert len(t.trajectory) == 3


class TestTsdfCheckpoint:
    """save_tsdf/load_tsdf: a resumed tracker must continue exactly as if
    the run had never stopped (pose, volume, and trajectory all restored)."""

    def _tracker(self, use_color=False):
        from realsensetracker_tpu.align.projective import ProjectiveIcpConfig
        from realsensetracker_tpu.tracking.tsdf_tracker import TsdfTracker

        icp = ProjectiveIcpConfig(
            iters=(3, 3), inner_iters=2, samples=768, min_samples=192
        )
        return TsdfTracker(INTR, volume=CFG, icp=icp, use_color=use_color)

    def test_roundtrip_continues_identically(self, tmp_path):
        from realsensetracker_tpu.tracking import checkpoint

        depths, _ = synthetic.render_trajectory(
            INTR, 6, scene=synthetic.default_scene(seed=3), seed=1,
            step_scale=0.01,
        )
        # Uninterrupted reference run.
        ref = self._tracker()
        for i in range(6):
            ref.process(depths[i], float(i))

        # Interrupted run: 4 frames, snapshot, fresh tracker, resume, 2 more.
        a = self._tracker()
        for i in range(4):
            a.process(depths[i], float(i))
        path = str(tmp_path / "tsdf_state.npz")
        checkpoint.save_tsdf(path, a)

        b = self._tracker()
        checkpoint.load_tsdf(path, b)
        assert b._index == 4
        assert len(b.trajectory) == 4
        np.testing.assert_allclose(np.asarray(b.pose), np.asarray(a.pose))
        np.testing.assert_array_equal(
            np.asarray(b._vol.tsdf), np.asarray(a._vol.tsdf)
        )
        for i in range(4, 6):
            res = b.process(depths[i], float(i))
            assert res.success
        np.testing.assert_allclose(
            np.asarray(b.pose), np.asarray(ref.pose), atol=1e-6
        )
        assert len(b.trajectory) == len(ref.trajectory)

    def test_roundtrip_color_volume(self, tmp_path):
        from realsensetracker_tpu.tracking import checkpoint

        depth = _wall_depth()
        color = np.full((H, W, 3), 0.5, np.float32)
        a = self._tracker(use_color=True)
        a.process(depth, 0.0, color=color)
        path = str(tmp_path / "tsdf_color.npz")
        checkpoint.save_tsdf(path, a)
        b = self._tracker(use_color=True)
        checkpoint.load_tsdf(path, b)
        np.testing.assert_array_equal(
            np.asarray(b._vol.color), np.asarray(a._vol.color)
        )
        # Color mismatch is rejected, not silently dropped.
        c = self._tracker(use_color=False)
        with pytest.raises(ValueError, match="color"):
            checkpoint.load_tsdf(path, c)

    def test_resolution_mismatch_rejected(self, tmp_path):
        from realsensetracker_tpu.tracking import checkpoint
        from realsensetracker_tpu.tracking.tsdf_tracker import TsdfTracker

        a = self._tracker()
        a.process(_wall_depth(), 0.0)
        path = str(tmp_path / "tsdf_res.npz")
        checkpoint.save_tsdf(path, a)
        b = TsdfTracker(INTR, volume=CFG._replace(resolution=32))
        with pytest.raises(ValueError, match="volume"):
            checkpoint.load_tsdf(path, b)

    def test_facade_unwrap(self, tmp_path):
        from realsensetracker_tpu.api.config import TrackerConfig
        from realsensetracker_tpu.api.tracker import Tracker
        from realsensetracker_tpu.tracking import checkpoint

        t = Tracker(TrackerConfig(intrinsics=INTR, method="tsdf", tsdf=CFG))
        t.process(_wall_depth(), 0.0)
        path = str(tmp_path / "tsdf_facade.npz")
        checkpoint.save_tsdf(path, t)
        t2 = Tracker(TrackerConfig(intrinsics=INTR, method="tsdf", tsdf=CFG))
        checkpoint.load_tsdf(path, t2)
        np.testing.assert_allclose(np.asarray(t2.pose), np.asarray(t.pose))
        # Non-TSDF trackers are rejected with a clear error.
        t3 = Tracker(TrackerConfig(intrinsics=INTR, method="projective"))
        with pytest.raises(ValueError, match="TSDF"):
            checkpoint.save_tsdf(str(tmp_path / "x.npz"), t3)


class TestOrientedSurface:
    """extract_surface_oriented: TSDF-gradient normals at the crossings."""

    def test_wall_normals_face_camera(self):
        depth = _wall_depth()
        vol = tsdf.integrate(
            tsdf.init_volume(CFG), depth, se3.identity(), INTR, CFG
        )
        cloud, normals = tsdf.extract_surface_oriented(vol, CFG, 16384)
        keep = np.asarray(cloud.mask)
        pts = np.asarray(cloud.points)[keep]
        nrm = np.asarray(normals)[keep]
        assert len(pts) > 500
        np.testing.assert_allclose(pts[:, 2], WALL_Z, atol=1e-3)
        # Unit length, pointing into free space (toward the camera, -z).
        np.testing.assert_allclose(np.linalg.norm(nrm, axis=1), 1.0,
                                   atol=1e-5)
        assert (nrm[:, 2] < -0.9).all()

    def test_sphere_normals_radial(self):
        scene = synthetic.Scene(
            sphere_centers=jnp.asarray([[0.0, 0.0, 2.0]], jnp.float32),
            sphere_radii=jnp.asarray([0.6], jnp.float32),
            floor_y=100.0, wall_z=100.0,
        )
        cfg = tsdf.TsdfConfig(
            resolution=64, voxel_size=0.05, origin=(-1.6, -1.6, 0.4),
            trunc=0.15, max_range=5.0,
        )
        depth = synthetic.render_depth(INTR, se3.identity(), scene)
        vol = tsdf.integrate(
            tsdf.init_volume(cfg), depth, se3.identity(), INTR, cfg
        )
        cloud, normals = tsdf.extract_surface_oriented(vol, cfg, 16384)
        keep = np.asarray(cloud.mask)
        pts = np.asarray(cloud.points)[keep]
        nrm = np.asarray(normals)[keep]
        out = pts - np.asarray([0.0, 0.0, 2.0])
        out /= np.linalg.norm(out, axis=1, keepdims=True)
        cos = (nrm * out).sum(axis=1)
        # Gradient normals on a carved sphere are outward almost
        # everywhere; the tail is silhouette voxels with one-sided
        # observations.
        assert (cos > 0.8).mean() > 0.95

    def test_tracker_property_and_ply(self, tmp_path):
        from realsensetracker_tpu.tracking.tsdf_tracker import TsdfTracker
        from realsensetracker_tpu.vis.render import export_ply

        tr = TsdfTracker(INTR, volume=CFG)
        assert tr.world_map_oriented is None
        tr.process(_wall_depth(), 0.0)
        cloud, normals = tr.world_map_oriented
        keep = np.asarray(cloud.mask)
        path = str(tmp_path / "oriented.ply")
        export_ply(path, np.asarray(cloud.points)[keep],
                   normals=np.asarray(normals)[keep])
        head = open(path).read(400).splitlines()
        assert "property float nx" in head
        row = open(path).read().splitlines()[
            head.index("end_header") + 1].split()
        assert len(row) == 6  # xyz + nxnynz


class TestPhotometricKinectFusion:
    """Joint geometric+photometric frame-to-model (TsdfTracker
    photometric=RgbdIcpConfig): the dense-model upgrade of align/rgbd.py.
    The defining case is a flat textured wall under in-plane motion --
    completely unobservable to depth-only point-to-plane."""

    VOL = tsdf.TsdfConfig(resolution=48, voxel_size=0.05,
                          origin=(-1.2, -1.2, -0.2625), trunc=0.15,
                          max_range=3.0, max_depth=4.0)

    @pytest.fixture(scope="class")
    def wall_slide(self):
        from realsensetracker_tpu.geometry import se3 as se3_mod

        wall = synthetic.Scene(
            sphere_centers=jnp.full((1, 3), 100.0),
            sphere_radii=jnp.full((1,), 0.01),
            floor_y=100.0, wall_z=2.0,
        )
        n = 10
        step = jnp.asarray([0.02, 0.01, 0.005, 0.0, 0.0, 0.0], jnp.float32)
        poses = [se3_mod.identity()]
        for _ in range(n - 1):
            poses.append(se3_mod.compose(poses[-1], se3_mod.exp(step)))
        poses = jnp.stack(poses)
        depths, colors = [], []
        for T in poses:
            d, c = synthetic.render_rgbd(INTR, T, wall)
            depths.append(np.asarray(d, np.float32))
            colors.append(np.asarray(c, np.float32))
        return depths, colors, np.asarray(poses)

    def _err(self, tr, gt):
        est = np.stack(list(tr.trajectory.poses))
        return np.linalg.norm(est[:, :3, 3] - gt[: len(est), :3, 3], axis=1)

    def test_pins_inplane_motion_on_degenerate_wall(self, wall_slide):
        from realsensetracker_tpu.align.projective import ProjectiveIcpConfig
        from realsensetracker_tpu.align.rgbd import RgbdIcpConfig
        from realsensetracker_tpu.tracking.tsdf_tracker import TsdfTracker

        depths, colors, gt = wall_slide
        icp = ProjectiveIcpConfig(iters=(3, 3), inner_iters=2, samples=768,
                                  min_samples=192)
        geo = TsdfTracker(INTR, volume=self.VOL, icp=icp, use_color=True)
        for f in range(len(depths)):
            geo.process(depths[f], float(f), color=colors[f])
        err_geo = self._err(geo, gt)
        # The slide is invisible to depth-only point-to-plane: the pose
        # barely moves, so the error approaches the full slide length.
        total = np.linalg.norm(gt[-1][:3, 3])
        assert err_geo.max() > 0.6 * total
        photo = TsdfTracker(
            INTR, volume=self.VOL, icp=icp, use_color=True,
            photometric=RgbdIcpConfig(iters=(5, 5), samples=768),
        )
        oks = 0
        for f in range(len(depths)):
            oks += int(photo.process(depths[f], float(f),
                                     color=colors[f]).success)
        err_photo = self._err(photo, gt)
        assert oks == len(depths)
        assert err_photo.max() < err_geo.max() / 4
        # "model" reference (trilinear fused-color render) also tracks,
        # strictly worse than the prev-frame reference (voxel-scale
        # intensity error in the render).
        model_ref = TsdfTracker(
            INTR, volume=self.VOL, icp=icp, use_color=True,
            photometric=RgbdIcpConfig(iters=(5, 5), samples=768),
            photometric_ref="model",
        )
        for f in range(len(depths)):
            model_ref.process(depths[f], float(f), color=colors[f])
        assert self._err(model_ref, gt).max() < err_geo.max() / 2

    def test_window_matches_per_frame_exactly(self, wall_slide):
        from realsensetracker_tpu.align.projective import ProjectiveIcpConfig
        from realsensetracker_tpu.align.rgbd import RgbdIcpConfig
        from realsensetracker_tpu.tracking.tsdf_tracker import TsdfTracker

        depths, colors, _ = wall_slide
        icp = ProjectiveIcpConfig(iters=(3, 3), inner_iters=2, samples=768,
                                  min_samples=192)
        photo = RgbdIcpConfig(iters=(5, 5), samples=768)
        a = TsdfTracker(INTR, volume=self.VOL, icp=icp, use_color=True,
                        photometric=photo)
        a.process_window(depths, [float(f) for f in range(len(depths))],
                         window=4, colors=colors)
        b = TsdfTracker(INTR, volume=self.VOL, icp=icp, use_color=True,
                        photometric=photo)
        for f in range(len(depths)):
            b.process(depths[f], float(f), color=colors[f])
        for pa, pb in zip(a.trajectory.poses, b.trajectory.poses):
            np.testing.assert_array_equal(np.asarray(pa), np.asarray(pb))

    def test_render_model_rgbd_color_fidelity(self, wall_slide):
        from realsensetracker_tpu.geometry import se3 as se3_mod

        depths, colors, _ = wall_slide
        vol = tsdf.init_volume(self.VOL, with_color=True)
        vol = tsdf.integrate(vol, jnp.asarray(depths[0]),
                             se3_mod.identity(), INTR, self.VOL,
                             color=jnp.asarray(colors[0]))
        d, g = tsdf.render_model_rgbd(vol, se3_mod.identity(), INTR,
                                      self.VOL)
        valid = np.asarray(d) > 0
        assert valid.mean() > 0.9
        luma = np.asarray(colors[0]) @ np.array([0.299, 0.587, 0.114])
        diff = np.abs(np.asarray(g) - luma)[valid]
        # Voxel-scale texture: render gray tracks the true image within
        # fused-color blur.
        assert np.median(diff) < 0.05
        with pytest.raises(ValueError, match="with_color"):
            tsdf.render_model_rgbd(
                tsdf.init_volume(self.VOL), se3_mod.identity(), INTR,
                self.VOL,
            )

    def test_facade_and_validation(self, wall_slide):
        from realsensetracker_tpu.api import Tracker, TrackerConfig
        from realsensetracker_tpu.tracking.tsdf_tracker import TsdfTracker

        depths, colors, gt = wall_slide
        t = Tracker(TrackerConfig(
            intrinsics=INTR, method="tsdf", tsdf=self.VOL,
            tsdf_color=True, tsdf_photometric=True,
        ))
        for f in range(4):
            r = t.process(depths[f], float(f), color=colors[f])
        assert r.success
        with pytest.raises(ValueError, match="use_color"):
            TsdfTracker(INTR, volume=self.VOL, photometric=object())
        with pytest.raises(ValueError, match="photometric_ref"):
            TsdfTracker(INTR, volume=self.VOL, use_color=True,
                        photometric=object(), photometric_ref="nope")


class TestSmallResolutionSchedule:
    """Regression for a small-resolution pitfall: the DEFAULT
    4-level ICP schedule at 80x60 built a 10x7 coarsest level that,
    combined with a partial-coverage model render (volume smaller than
    the scene), diverged. fit_levels (align/projective.py) now truncates
    the schedule automatically; tiny-smoke dense configs must work on
    DEFAULT settings without hand-sized volumes."""

    def test_tsdf_tracker_default_icp_tracks_partial_coverage(self):
        from realsensetracker_tpu.tracking.tsdf_tracker import TsdfTracker

        intr = camera.Intrinsics(fx=64.0, fy=64.0, cx=39.5, cy=29.5,
                                 width=80, height=60)
        # 2.4 m volume against the default scene (content out to z=3.5):
        # the model render covers only part of the frame.
        vol = tsdf.TsdfConfig(resolution=48, voxel_size=0.05,
                              origin=(-1.2, -1.2, -0.2625), trunc=0.15,
                              max_range=3.0)
        scene = synthetic.default_scene(seed=5)
        F = 16
        depths, gt = synthetic.render_trajectory(
            intr, F, scene=scene, seed=2, step_scale=0.02
        )
        depths = np.asarray(depths, np.float32)
        tr = TsdfTracker(intr=intr, volume=vol)  # DEFAULT icp schedule
        successes = sum(
            tr.process(depths[i], float(i)).success for i in range(F)
        )
        err = np.linalg.norm(
            np.asarray(tr.pose)[:3, 3] - np.asarray(gt[F - 1])[:3, 3]
        )
        # Pre-fix: 2/16 frames tracked, 90 mm endpoint error.
        assert successes >= 9
        assert err < 0.06


class TestU16Tsdf:
    """Raw uint16 frames through the dense tracker: seed, per-frame step
    and the windowed scan convert on device (depth_scale static arg) and
    must match identically-quantized f32 meters exactly."""

    def test_u16_matches_f32_per_frame_and_windowed(self):
        from realsensetracker_tpu.align.projective import ProjectiveIcpConfig
        from realsensetracker_tpu.tracking.tsdf_tracker import TsdfTracker

        icp = ProjectiveIcpConfig(
            iters=(3, 3), inner_iters=2, samples=768, min_samples=192
        )
        scene = synthetic.default_scene(seed=3)
        depths, _ = synthetic.render_trajectory(
            INTR, 5, scene=scene, seed=1, step_scale=0.01
        )
        scale = 1.0 / 5000.0
        raw = [np.asarray(np.asarray(d) * 5000.0 + 0.5, np.uint16)
               for d in depths]
        quant = [r.astype(np.float32) * np.float32(scale) for r in raw]
        a = TsdfTracker(INTR, volume=CFG, icp=icp)
        b = TsdfTracker(INTR, volume=CFG, icp=icp, depth_scale=scale)
        w = TsdfTracker(INTR, volume=CFG, icp=icp, depth_scale=scale)
        ra = [a.process(d, float(i)) for i, d in enumerate(quant)]
        rb = [b.process(d, float(i)) for i, d in enumerate(raw)]
        rw = w.process_window(raw, [float(i) for i in range(5)], window=4)
        for x, y, z in zip(ra, rb, rw):
            assert x.success == y.success == z.success
            np.testing.assert_allclose(x.pose, y.pose, atol=1e-6)
            np.testing.assert_allclose(x.pose, z.pose, atol=1e-6)
