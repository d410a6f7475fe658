"""Submap atlas: unbounded dense mapping from fixed-shape TSDF volumes.

Covers the mapping/submaps.py handover machinery (spawn policy,
model-render seeding, world-frame composition), its checkpoint format,
the api.Tracker facade wiring, and the rs_replay CLI surface. The
corridor scenario is the defining case: a 2 m translation that exits the
2.4 m volume, impossible for a single fixed-extent TSDF tracker
(reference world-model analog: the unbounded CloudAccumulator,
rs_replay_app.cpp:76-129).
"""

import numpy as np
import pytest

import jax.numpy as jnp

from realsensetracker_tpu.align.projective import ProjectiveIcpConfig
from realsensetracker_tpu.data import synthetic
from realsensetracker_tpu.geometry import camera
from realsensetracker_tpu.mapping.submaps import SubmapConfig, SubmapTsdfTracker
from realsensetracker_tpu.mapping.tsdf import TsdfConfig
from realsensetracker_tpu.tracking.tsdf_tracker import TsdfTracker

W, H = 80, 60
INTR = camera.Intrinsics(fx=64.0, fy=64.0, cx=(W - 1) / 2, cy=(H - 1) / 2,
                         width=W, height=H)
ICP = ProjectiveIcpConfig(iters=(3, 3), inner_iters=2, samples=768,
                          min_samples=192)
# 2.4 m cube, 5 cm voxels -- the corridor walk (2 m) exits it.
VOL = TsdfConfig(resolution=48, voxel_size=0.05,
                 origin=(-1.2, -1.2, -0.2625), trunc=0.15,
                 max_range=3.0, max_depth=4.0)
F = 48
SPAN = 2.0  # meters of +x translation over the F frames


def _corridor_scene():
    rng = np.random.RandomState(3)
    n = 12
    cx = np.linspace(-0.5, SPAN + 1.0, n)
    centers = np.stack(
        [cx, rng.uniform(-0.3, 0.55, n), rng.uniform(0.9, 1.6, n)], 1
    ).astype(np.float32)
    radii = rng.uniform(0.16, 0.32, n).astype(np.float32)
    return synthetic.Scene(
        sphere_centers=jnp.asarray(centers),
        sphere_radii=jnp.asarray(radii),
        floor_y=0.9, wall_z=2.2,
    )


@pytest.fixture(scope="module")
def corridor():
    poses = np.tile(np.eye(4, dtype=np.float32), (F, 1, 1))
    poses[:, 0, 3] = np.linspace(0.0, SPAN, F)
    depths, _ = synthetic.render_trajectory(
        INTR, F, scene=_corridor_scene(), poses=jnp.asarray(poses)
    )
    return np.asarray(depths, np.float32), poses


def _ate(traj, gt_poses):
    est = np.stack(list(traj.poses))
    return np.linalg.norm(est[:, :3, 3] - gt_poses[: len(est), :3, 3],
                          axis=1)


def _out_and_back(corridor):
    """Extend the outbound corridor fixture with its reversed return leg.

    Returns (depths (2F-1, H, W), gt poses (2F-1, 4, 4))."""
    depths_out, gt_out = corridor
    poses = np.concatenate([gt_out, gt_out[::-1][1:]], axis=0)
    ret_depths, _ = synthetic.render_trajectory(
        INTR, len(poses) - F, scene=_corridor_scene(),
        poses=jnp.asarray(poses[F:]),
    )
    return (np.concatenate([depths_out, np.asarray(ret_depths,
                                                   np.float32)]),
            poses)


class TestCorridor:
    def test_atlas_outruns_single_volume(self, corridor):
        depths, gt = corridor
        tr = SubmapTsdfTracker(INTR, SubmapConfig(volume=VOL), icp=ICP)
        ok = sum(int(tr.process(depths[f], float(f)).success)
                 for f in range(F))
        err = _ate(tr.trajectory, gt)
        assert ok == F
        assert tr.num_submaps >= 3
        assert err.max() < 0.12  # < 6% of the 2 m span
        # Single fixed volume on the same walk: loses tracking and/or
        # blows up once the camera exits the grid.
        ts = TsdfTracker(INTR, volume=VOL, icp=ICP)
        ok_single = sum(int(ts.process(depths[f], float(f)).success)
                        for f in range(F))
        err_single = _ate(ts.trajectory, gt)
        assert ok_single < F or err_single.max() > 3 * err.max()
        # The union world map spans the whole corridor; one volume can't.
        wm = tr.world_map
        pts = np.asarray(wm.points)[np.asarray(wm.mask)]
        assert pts[:, 0].min() < -0.8
        assert pts[:, 0].max() > SPAN - 0.4
        extent = VOL.resolution * VOL.voxel_size
        assert pts[:, 0].max() - pts[:, 0].min() > extent

    def test_anchors_compose_world_poses(self, corridor):
        depths, _ = corridor
        tr = SubmapTsdfTracker(INTR, SubmapConfig(volume=VOL), icp=ICP)
        for f in range(F):
            r = tr.process(depths[f], float(f))
        # The last world pose is anchor @ (active-submap-local pose).
        np.testing.assert_allclose(
            r.pose, tr.anchor @ np.asarray(tr._t.pose), atol=1e-6
        )
        # Every finished submap fused at least min_frames frames.
        assert all(s.frames >= tr.config.min_frames for s in tr.finished)
        # Offloaded volumes live on host.
        assert all(isinstance(s.volume.tsdf, np.ndarray)
                   for s in tr.finished)

    def test_windowed_run_spawns_and_tracks(self, corridor):
        depths, gt = corridor
        tr = SubmapTsdfTracker(INTR, SubmapConfig(volume=VOL), icp=ICP)
        rs = tr.process_window(list(depths), [float(f) for f in range(F)],
                               window=8)
        assert len(rs) == F and all(r.success for r in rs)
        assert tr.num_submaps >= 2  # chunk-granular spawns still fire
        assert _ate(tr.trajectory, gt).max() < 0.15


class TestAtlasOptimization:
    def test_out_and_back_loop_reduces_endpoint_error(self, corridor):
        """Walk 2 m out and back: the return submaps overlap the outbound
        ones, loop edges snap the accumulated drift, and the endpoint
        error drops -- without re-fusing a single volume."""
        from realsensetracker_tpu.mapping.submaps import optimize_atlas

        depths, poses = _out_and_back(corridor)
        n = len(depths)
        # reactivate=False isolates the pose-graph path: with it on, the
        # return leg re-enters the outbound submaps and the drift is
        # already snapped at reactivation (tested separately below).
        tr = SubmapTsdfTracker(
            INTR, SubmapConfig(volume=VOL, reactivate=False), icp=ICP
        )
        ok = sum(int(tr.process(depths[f], float(f)).success)
                 for f in range(n))
        assert ok == n
        assert tr.num_submaps >= 4
        err_pre = _ate(tr.trajectory, poses)
        anchors_pre = [s.world_from_submap.copy() for s in tr.finished]
        loops = optimize_atlas(tr, surface_capacity=1024)
        assert loops >= 1
        err_post = _ate(tr.trajectory, poses)
        # Endpoint (loop-closure point) improves; global ATE not worse.
        assert err_post[-1] < err_pre[-1]
        assert err_post.mean() < err_pre.mean() * 1.05
        # Anchors actually moved, and the facade pose tracks the
        # rewritten trajectory.
        moved = any(
            not np.allclose(a, s.world_from_submap)
            for a, s in zip(anchors_pre, tr.finished)
        )
        assert moved
        np.testing.assert_allclose(
            tr.pose, np.asarray(tr.trajectory.poses[-1], np.float32),
            atol=1e-5,
        )
        # World pose of the active submap still composes through its
        # (optimized) anchor.
        np.testing.assert_allclose(
            tr.pose, tr.anchor @ np.asarray(tr._t.pose), atol=1e-5
        )

    def test_reactivation_reuses_submaps_and_snaps_drift(self, corridor):
        """With reactivation on, the return leg re-enters the outbound
        submaps: fewer volumes than the no-reactivate run, the active id
        returns to an old submap, and registering against the old maps
        bounds the endpoint error WITHOUT any pose-graph pass."""
        depths, poses = _out_and_back(corridor)
        n = len(depths)
        a = SubmapTsdfTracker(
            INTR, SubmapConfig(volume=VOL, reactivate=False), icp=ICP
        )
        b = SubmapTsdfTracker(INTR, SubmapConfig(volume=VOL), icp=ICP)
        for f in range(n):
            ra = a.process(depths[f], float(f))
            rb = b.process(depths[f], float(f))
            assert ra.success and rb.success
        assert b.num_submaps < a.num_submaps
        assert b.active_id < b.num_submaps - 1  # went BACK to an old map
        err_a = _ate(a.trajectory, poses)
        err_b = _ate(b.trajectory, poses)
        assert err_b[-1] <= err_a[-1]
        # Span log covers the whole trajectory, boundaries increasing,
        # and revisited submaps own multiple spans.
        log = b._span_log
        assert log[0][0] == 0
        assert all(log[e][0] < log[e + 1][0] for e in range(len(log) - 1))
        sids = [sid for _, sid in log]
        assert len(sids) > len(set(sids))  # at least one submap revisited
        # World pose still composes through the active anchor.
        np.testing.assert_allclose(
            b.pose, b.anchor @ np.asarray(b._t.pose), atol=1e-5
        )

    def test_optimize_atlas_respects_span_log(self, corridor):
        """optimize_atlas on a reactivating run rewrites every span with
        its submap's correction and does not degrade the trajectory."""
        from realsensetracker_tpu.mapping.submaps import optimize_atlas

        depths, poses = _out_and_back(corridor)
        tr = SubmapTsdfTracker(INTR, SubmapConfig(volume=VOL), icp=ICP)
        for f in range(len(depths)):
            tr.process(depths[f], float(f))
        err_pre = _ate(tr.trajectory, poses)
        loops = optimize_atlas(tr, surface_capacity=1024)
        err_post = _ate(tr.trajectory, poses)
        assert err_post.mean() < err_pre.mean() * 1.1
        np.testing.assert_allclose(
            tr.pose, np.asarray(tr.trajectory.poses[-1], np.float32),
            atol=1e-5,
        )
        np.testing.assert_allclose(
            tr.pose, tr.anchor @ np.asarray(tr._t.pose), atol=1e-5
        )

    def test_too_few_submaps_is_noop(self, corridor):
        from realsensetracker_tpu.mapping.submaps import optimize_atlas

        depths, _ = corridor
        tr = SubmapTsdfTracker(INTR, SubmapConfig(volume=VOL), icp=ICP)
        for f in range(8):
            tr.process(depths[f], float(f))
        before = [np.asarray(p).copy() for p in tr.trajectory.poses]
        assert optimize_atlas(tr) == 0
        for a, b in zip(before, tr.trajectory.poses):
            np.testing.assert_array_equal(a, b)


class TestParityAndExports:
    def test_huge_radius_is_bit_identical_to_single_volume(self, corridor):
        depths, _ = corridor
        n = 12
        tr = SubmapTsdfTracker(
            INTR, SubmapConfig(volume=VOL, spawn_radius=1e9), icp=ICP
        )
        ts = TsdfTracker(INTR, volume=VOL, icp=ICP)
        for f in range(n):
            ra = tr.process(depths[f], float(f))
            rb = ts.process(depths[f], float(f))
            np.testing.assert_array_equal(ra.pose, rb.pose)
        assert tr.num_submaps == 1
        np.testing.assert_array_equal(
            np.asarray(tr.tsdf_volume.tsdf), np.asarray(ts._vol.tsdf)
        )

    def test_world_exports(self, corridor):
        depths, _ = corridor
        tr = SubmapTsdfTracker(INTR, SubmapConfig(volume=VOL), icp=ICP,
                               surface_capacity=4096)
        for f in range(F // 2):
            tr.process(depths[f], float(f))
        k = tr.num_submaps
        wm = tr.world_map
        assert wm.points.shape == (k * 4096, 3)
        assert int(wm.count()) > 0
        cloud, normals = tr.world_map_oriented
        assert normals.shape == (k * 4096, 3)
        m = np.asarray(cloud.mask)
        nn = np.linalg.norm(np.asarray(normals)[m], axis=1)
        np.testing.assert_allclose(nn, 1.0, atol=1e-3)
        mesh = tr.world_mesh(capacity=16384)
        assert mesh.vertices.shape[0] >= 4096 * k
        assert int(mesh.mask.sum()) > 0
        assert tr.world_map_colored is None  # geometric tracker


class TestColoredAtlas:
    def test_colored_submaps_track_export_and_roundtrip(self, tmp_path):
        """use_color atlas: spawns fuse color through the handover (the
        model-render seed borrows the frame's color), the union colored
        map exports, and the checkpoint carries the color planes."""
        from realsensetracker_tpu.tracking import checkpoint

        scene = _corridor_scene()
        n = 28
        poses = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
        poses[:, 0, 3] = np.linspace(0.0, 1.4, n)
        depths, colors, _ = synthetic.render_trajectory_rgbd(
            INTR, n, scene=scene, poses=jnp.asarray(poses)
        )
        depths = np.asarray(depths, np.float32)
        colors = np.asarray(colors, np.float32)
        tr = SubmapTsdfTracker(INTR, SubmapConfig(volume=VOL), icp=ICP,
                               surface_capacity=4096, use_color=True)
        for f in range(n):
            r = tr.process(depths[f], float(f), color=colors[f])
            assert r.success
        assert tr.num_submaps >= 2
        cloud, cols = tr.world_map_colored
        assert cols.shape == (tr.num_submaps * 4096, 3)
        m = np.asarray(cloud.mask)
        c = np.asarray(cols)[m]
        assert c.min() >= 0.0 and c.max() <= 1.0
        assert c.std() > 0.01  # actually colored, not constant
        path = str(tmp_path / "colored_atlas.npz")
        checkpoint.save_submaps(path, tr)
        b = SubmapTsdfTracker(INTR, SubmapConfig(volume=VOL), icp=ICP,
                              surface_capacity=4096, use_color=True)
        checkpoint.load_submaps(path, b)
        assert b.num_submaps == tr.num_submaps
        np.testing.assert_allclose(
            np.asarray(b._t.tsdf_volume.color),
            np.asarray(tr._t.tsdf_volume.color), atol=1e-6,
        )
        plain = SubmapTsdfTracker(INTR, SubmapConfig(volume=VOL), icp=ICP)
        with pytest.raises(ValueError, match="color"):
            checkpoint.load_submaps(path, plain)


class TestCheckpointAndFacade:
    def test_checkpoint_roundtrip_continues_identically(self, corridor,
                                                        tmp_path):
        from realsensetracker_tpu.tracking import checkpoint

        depths, _ = corridor
        split = F // 2
        a = SubmapTsdfTracker(INTR, SubmapConfig(volume=VOL), icp=ICP)
        for f in range(split):
            a.process(depths[f], float(f))
        assert a.num_submaps >= 2  # the snapshot holds a real atlas
        path = str(tmp_path / "atlas.npz")
        checkpoint.save_submaps(path, a)

        b = SubmapTsdfTracker(INTR, SubmapConfig(volume=VOL), icp=ICP)
        checkpoint.load_submaps(path, b)
        assert b.num_submaps == a.num_submaps
        assert len(b.trajectory) == split
        for f in range(split, F):
            ra = a.process(depths[f], float(f))
            rb = b.process(depths[f], float(f))
            np.testing.assert_allclose(ra.pose, rb.pose, atol=1e-6)
        assert b.num_submaps == a.num_submaps

    def test_checkpoint_geometry_mismatch_rejected(self, corridor,
                                                   tmp_path):
        from realsensetracker_tpu.tracking import checkpoint

        depths, _ = corridor
        a = SubmapTsdfTracker(INTR, SubmapConfig(volume=VOL), icp=ICP)
        for f in range(6):
            a.process(depths[f], float(f))
        path = str(tmp_path / "atlas.npz")
        checkpoint.save_submaps(path, a)
        wrong = SubmapTsdfTracker(
            INTR,
            SubmapConfig(volume=VOL._replace(voxel_size=0.06)),
            icp=ICP,
        )
        with pytest.raises(ValueError, match="geometry"):
            checkpoint.load_submaps(path, wrong)
        single = TsdfTracker(INTR, volume=VOL, icp=ICP)
        with pytest.raises(ValueError, match="submap"):
            checkpoint.load_submaps(path, single)

    def test_tracker_facade_routes_submaps(self, corridor):
        from realsensetracker_tpu.api import Tracker, TrackerConfig

        depths, _ = corridor
        t = Tracker(TrackerConfig(
            intrinsics=INTR, method="tsdf", tsdf=VOL, projective=ICP,
            tsdf_submap_radius=0.6,
        ))
        assert isinstance(t._impl, SubmapTsdfTracker)
        for f in range(0, F, 2):  # coarser steps still track
            r = t.process(depths[f], float(f))
            assert r.success
        assert t._impl.num_submaps >= 2
        assert t.world_map is not None

    def test_rs_replay_submap_cli(self, corridor, tmp_path):
        from realsensetracker_tpu.cli import rs_replay
        from realsensetracker_tpu.data.tum import synthesize_tum_sequence

        root = synthesize_tum_sequence(str(tmp_path / "seq"), num_frames=6,
                                       seed=0, width=W, height=H)
        state = str(tmp_path / "atlas.npz")
        rc = rs_replay.main([
            "--tum", root, "--method", "tsdf", "--frame-interval", "0",
            "--tsdf-resolution", "48", "--tsdf-voxel", "0.05",
            "--submap-radius", "0.6", "--save-state", state,
        ])
        assert rc == 0
        rc = rs_replay.main([
            "--tum", root, "--method", "tsdf", "--frame-interval", "0",
            "--tsdf-resolution", "48", "--tsdf-voxel", "0.05",
            "--submap-radius", "0.6", "--resume-state", state,
            "--start-frame", "5",
        ])
        assert rc == 0
        rc = rs_replay.main([
            "--tum", root, "--method", "projective",
            "--frame-interval", "0", "--submap-radius", "0.6",
        ])
        assert rc == 1  # submaps require the dense method


class TestAtlasScaling:
    """optimize_atlas at 20 submaps: the warped-occupancy mid-gate must
    prune geometry-dissimilar anchor-near pairs BEFORE the expensive
    register+ICP dispatch (and before any volume upload / surface
    extraction), while keeping true revisits; the sharded pair verify
    must match the single-device result."""

    N = 20

    @classmethod
    def _atlas(cls, n=None):
        """A synthetic n-submap corridor atlas whose LAST submap revisits
        the first place (anchors 1 m apart, per-meter sphere clusters,
        no wall in range). Volumes are built directly (one frame fused
        per submap) -- tracking 20 submaps' worth of frames would
        dominate the test's runtime without exercising anything new."""
        import jax

        from realsensetracker_tpu.mapping import tsdf as tsdf_mod
        from realsensetracker_tpu.mapping.submaps import Submap

        n = n or cls.N
        rng = np.random.RandomState(7)
        centers, radii = [], []
        for m in range(n + 2):
            for _ in range(3):
                centers.append([m * 1.0 + rng.uniform(-0.4, 0.4),
                                rng.uniform(-0.3, 0.5),
                                rng.uniform(0.9, 1.6)])
                radii.append(rng.uniform(0.16, 0.3))
        scene = synthetic.Scene(
            sphere_centers=jnp.asarray(centers, jnp.float32),
            sphere_radii=jnp.asarray(radii, jnp.float32),
            floor_y=0.9, wall_z=50.0,
        )
        xs = [float(i) for i in range(n - 1)] + [0.02]
        tr = SubmapTsdfTracker(INTR, SubmapConfig(volume=VOL), icp=ICP)
        for i, x in enumerate(xs):
            pose = np.eye(4, dtype=np.float32)
            pose[0, 3] = x
            depth = synthetic.render_depth(INTR, jnp.asarray(pose), scene)
            from realsensetracker_tpu.mapping import tsdf as tm

            vol = tm.integrate(tm.init_volume(VOL), depth, jnp.eye(4),
                               INTR, VOL)
            tr._subs.append(Submap(world_from_submap=pose.copy(),
                                   volume=jax.tree.map(np.asarray, vol),
                                   frames=1))
            tr._span_log.append((i, i))
            tr.trajectory.append(float(i), pose.copy())
            last_vol, last_pose = vol, pose
        tr._active_id = len(xs) - 1
        tr._anchor = last_pose.copy()
        tr._t._vol = last_vol
        tr._t._pose = jnp.eye(4)
        tr._t._pose_np = np.eye(4, dtype=np.float32)
        tr._pose_np = last_pose.copy()
        return tr

    def test_occupancy_gate_prunes_pairs_and_keeps_revisit(self):
        from realsensetracker_tpu.mapping import submaps as sm

        tr = self._atlas()
        orig = sm._verify_submap_pairs
        seen = {}

        def spy(surfs, feats, pairs, **kw):
            seen["verified"] = len(pairs)
            seen["extracted"] = len(surfs)
            return orig(surfs, feats, pairs, **kw)

        sm._verify_submap_pairs = spy
        try:
            edges = sm.optimize_atlas(tr, surface_capacity=1024)
        finally:
            sm._verify_submap_pairs = orig
        # 20 anchor-gated candidates collapse to the genuinely
        # overlapping few; only those submaps pay extraction.
        assert seen["verified"] <= 4, seen
        assert seen["extracted"] <= 6, seen
        # The revisit edge (0 <- last) must survive the gate and verify.
        assert edges >= 1
        # After optimization the revisited anchors must coincide (the
        # loop edge pulls the drifted 2 cm offset together).
        d = np.linalg.norm(
            tr._subs[0].world_from_submap[:3, 3]
            - tr._anchor[:3, 3]
        )
        assert d < 0.05

    def test_gate_disabled_verifies_all_anchor_pairs(self):
        from realsensetracker_tpu.mapping import submaps as sm

        tr = self._atlas(8)
        orig = sm._verify_submap_pairs
        seen = {}

        def spy(surfs, feats, pairs, **kw):
            seen["verified"] = len(pairs)
            return orig(surfs, feats, pairs, **kw)

        sm._verify_submap_pairs = spy
        try:
            sm.optimize_atlas(tr, surface_capacity=1024,
                              occupancy_gate=0.0)
        finally:
            sm._verify_submap_pairs = orig
        # Without the mid-gate every anchor-gated pair pays verification.
        assert seen["verified"] >= 6, seen

    def test_sharded_pair_verify_matches_single_device(self):
        import jax
        from jax.sharding import Mesh

        from realsensetracker_tpu.mapping import submaps as sm
        from realsensetracker_tpu.mapping import tsdf as tm
        from realsensetracker_tpu.ops import fpfh as fpfh_mod

        tr = self._atlas(6)
        surfs, feats = [], []
        for s in tr.submaps[:4]:
            vol = jax.tree.map(jnp.asarray, s.volume)
            c, n = tm.extract_surface_oriented(vol, VOL, 512)
            surfs.append(c)
            feats.append(fpfh_mod.compute_fpfh_from_normals(
                c, n, 6 * VOL.voxel_size, 64
            ))
        pairs = [(0, 1), (0, 2), (1, 3), (2, 3), (0, 3)]
        kw = dict(noise_bound=4 * VOL.voxel_size,
                  overlap_tau=2 * VOL.voxel_size, min_overlap=0.7,
                  refine_iters=8)
        T0, ok0, ov0 = sm._verify_submap_pairs(surfs, feats, pairs, **kw)
        mesh = Mesh(np.asarray(jax.devices()), ("data",))
        T1, ok1, ov1 = sm._verify_submap_pairs(surfs, feats, pairs,
                                               mesh=mesh, **kw)
        np.testing.assert_allclose(np.asarray(T0), np.asarray(T1),
                                   atol=1e-5)
        np.testing.assert_array_equal(np.asarray(ok0), np.asarray(ok1))
        np.testing.assert_allclose(np.asarray(ov0), np.asarray(ov1),
                                   atol=1e-5)


class TestAutoSlab:
    """SubmapConfig.auto_slab: submap volumes default integrate_slab to
    3V/4 (bounded local scenes are the slab's regime, and the slab fuses
    the same volume)."""

    def test_defaults_on(self):
        tr = SubmapTsdfTracker(INTR, SubmapConfig(volume=VOL), icp=ICP)
        assert tr.config.volume.integrate_slab == 3 * VOL.resolution // 4
        assert tr._t.volume.integrate_slab == 3 * VOL.resolution // 4

    def test_respects_explicit_and_opt_out(self):
        explicit = SubmapConfig(volume=VOL._replace(integrate_slab=20))
        tr = SubmapTsdfTracker(INTR, explicit, icp=ICP)
        assert tr.config.volume.integrate_slab == 20
        off = SubmapConfig(volume=VOL, auto_slab=False)
        tr2 = SubmapTsdfTracker(INTR, off, icp=ICP)
        assert tr2.config.volume.integrate_slab == 0
