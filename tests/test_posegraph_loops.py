"""Pose-graph optimization + loop-closure detection tests (the reference's
planned-but-never-built `optimize` and `loop_closure` modules)."""

import jax
import jax.numpy as jnp
import numpy as np

from realsensetracker_tpu.geometry import se3
from realsensetracker_tpu.loop_closure import KeyframeDatabase, global_descriptor
from realsensetracker_tpu.ops import cloud as cloud_mod
from realsensetracker_tpu.optimize import pose_graph as pg


def _noisy_loop_trajectory(n=12, drift=0.02, seed=0):
    """Ground-truth loop + drifty odometry estimates + a loop-closure edge."""
    rng = np.random.RandomState(seed)
    # Ground truth: walk around a circle back to the start.
    gt = [np.eye(4, dtype=np.float32)]
    steps = []
    for i in range(n - 1):
        ang = 2 * np.pi / (n - 1)
        step = np.asarray(
            se3.exp(jnp.asarray([0.5, 0, 0, 0, 0, ang], jnp.float32))
        )
        steps.append(step)
        gt.append((gt[-1] @ step).astype(np.float32))
    # Odometry: each step perturbed -> accumulated drift.
    est = [np.eye(4, dtype=np.float32)]
    for s in steps:
        noise = np.asarray(
            se3.exp(jnp.asarray(drift * rng.randn(6), jnp.float32))
        )
        est.append((est[-1] @ s @ noise).astype(np.float32))
    return np.stack(gt), np.stack(est), steps


class TestPoseGraph:
    def test_odometry_only_is_stationary(self):
        # With only self-consistent odometry edges the graph is at optimum.
        _, est, _ = _noisy_loop_trajectory()
        graph = pg.from_trajectory(jnp.asarray(est))
        poses, cost = pg.optimize_pose_graph(graph, gn_iters=3, cg_iters=30)
        assert float(cost) < 1e-8
        np.testing.assert_allclose(np.asarray(poses), est, atol=1e-4)

    def test_loop_closure_removes_drift(self):
        gt, est, _ = _noisy_loop_trajectory(n=12, drift=0.03)
        n = len(est)
        # Loop edge: last node coincides with first in ground truth.
        T_loop = np.linalg.inv(gt[0]) @ gt[-1]
        graph = pg.from_trajectory(
            jnp.asarray(est), loop_edges=[(0, n - 1, T_loop.astype(np.float32), 4.0)]
        )
        end_err_before = np.linalg.norm(est[-1][:3, 3] - gt[-1][:3, 3])
        poses, cost = pg.optimize_pose_graph(graph, gn_iters=15, cg_iters=60)
        poses = np.asarray(poses)
        end_err_after = np.linalg.norm(poses[-1][:3, 3] - gt[-1][:3, 3])
        assert end_err_after < 0.5 * end_err_before
        assert np.isfinite(float(cost))

    def test_huber_bounds_outlier_edge_damage(self):
        """A single grossly-wrong loop edge must not drag an otherwise
        self-consistent trajectory far (Huber IRLS on edge residuals)."""
        gt, est, _ = _noisy_loop_trajectory(n=10, drift=0.0)
        n = len(est)
        # est == gt (no drift): the graph is at optimum except for one
        # wildly wrong loop edge.
        T_bad = np.asarray(
            se3.exp(jnp.asarray([0.5, -0.3, 0.4, 0.4, -0.3, 0.5], jnp.float32))
        ) @ (np.linalg.inv(gt[0]) @ gt[-1])
        graph = pg.from_trajectory(
            jnp.asarray(est), loop_edges=[(0, n - 1, T_bad.astype(np.float32), 1.0)]
        )
        poses_rob, _ = pg.optimize_pose_graph(
            graph, gn_iters=10, cg_iters=50, huber_delta=0.1
        )
        err_rob = max(
            np.linalg.norm(np.asarray(poses_rob)[k][:3, 3] - gt[k][:3, 3])
            for k in range(n)
        )
        poses_ls, _ = pg.optimize_pose_graph(
            graph, gn_iters=10, cg_iters=50, huber_delta=0.0
        )
        err_ls = max(
            np.linalg.norm(np.asarray(poses_ls)[k][:3, 3] - gt[k][:3, 3])
            for k in range(n)
        )
        # Robust kernel must beat plain least squares substantially.
        assert err_rob < 0.5 * err_ls

    def test_1000_node_graph_preconditioned_convergence(self):
        """Scale test: 5 laps x 200 nodes with ~5% exact
        loop edges and drifty odometry. Backbone-factorized PCG at the
        standard 60-iteration budget must match an unpreconditioned LONG-CG
        reference and clearly beat unpreconditioned CG at the same budget
        (plain CG's condition number grows with chain length^2; plain
        block-Jacobi also fails this test -- it is local, so information
        still moves one node per iteration)."""
        laps, per_lap = 5, 200
        n = laps * per_lap
        rng = np.random.RandomState(3)
        ang = 2 * np.pi / per_lap
        step = np.asarray(
            se3.exp(jnp.asarray([0.3, 0, 0, 0, 0, ang], jnp.float32))
        )
        gt = [np.eye(4, dtype=np.float32)]
        est = [np.eye(4, dtype=np.float32)]
        for _ in range(n - 1):
            gt.append((gt[-1] @ step).astype(np.float32))
            noise = np.asarray(
                se3.exp(jnp.asarray(0.01 * rng.randn(6), jnp.float32))
            )
            est.append((est[-1] @ step @ noise).astype(np.float32))
        gt, est = np.stack(gt), np.stack(est)
        # ~5% loop edges: node i revisits node i - per_lap exactly in GT.
        loops = []
        for i in range(per_lap, n, 20):
            T_ij = (np.linalg.inv(gt[i - per_lap]) @ gt[i]).astype(np.float32)
            loops.append((i - per_lap, i, T_ij, 1.0))
        graph = pg.from_trajectory(jnp.asarray(est), loop_edges=loops)

        kw = dict(gn_iters=6, huber_delta=0.1)
        poses_pcg, cost_pcg = pg.optimize_pose_graph(
            graph, cg_iters=60, precondition=True, **kw
        )
        _, cost_plain60 = pg.optimize_pose_graph(
            graph, cg_iters=60, precondition=False, **kw
        )
        _, cost_ref = pg.optimize_pose_graph(
            graph, cg_iters=1500, precondition=False, **kw
        )
        cost_pcg, cost_plain60, cost_ref = map(
            float, (cost_pcg, cost_plain60, cost_ref)
        )
        # PCG at 60 iters matches the exhaustive reference...
        assert cost_pcg <= 1.05 * cost_ref + 1e-8
        # ...and the same budget without preconditioning falls short.
        assert cost_plain60 > 1.5 * cost_pcg
        # The optimized trajectory actually improved: max position error
        # against ground truth shrinks vs raw drifty odometry.
        err_before = max(
            np.linalg.norm(est[k][:3, 3] - gt[k][:3, 3]) for k in range(n)
        )
        err_after = max(
            np.linalg.norm(np.asarray(poses_pcg)[k][:3, 3] - gt[k][:3, 3])
            for k in range(n)
        )
        assert err_after < 0.5 * err_before

    def test_lm_safeguard_survives_meter_scale_drift(self):
        """Regression (round 3): an unsafeguarded GN loop diverges to NaN
        on large drifted graphs whose loop residuals approach the pi
        rotation branch cut (first seen on a real 229-keyframe, 48-loop
        aggressive-motion run). The LM accept/reject + trust-region step
        must keep the solve finite AND actually remove the drift."""
        n = 80
        # Ground truth: straight walk in x.
        step_gt = np.asarray(
            se3.exp(jnp.asarray([0.05, 0, 0, 0, 0, 0], jnp.float32))
        )
        gt = [np.eye(4, dtype=np.float32)]
        for _ in range(n - 1):
            gt.append((gt[-1] @ step_gt).astype(np.float32))
        # Estimate: every step also drifts 0.042 rad about z -> the final
        # node's orientation error is ~3.3 rad, past the branch cut.
        step_est = np.asarray(
            se3.exp(jnp.asarray([0.05, 0, 0, 0, 0, 0.042], jnp.float32))
        )
        est = [np.eye(4, dtype=np.float32)]
        for _ in range(n - 1):
            est.append((est[-1] @ step_est).astype(np.float32))
        gt, est = np.stack(gt), np.stack(est)

        loops = []
        for j in (n - 1, n - 2, n - 3, n // 2):
            T_true = (np.linalg.inv(gt[0]) @ gt[j]).astype(np.float32)
            loops.append((0, j, T_true, 1.0))
        graph = pg.from_trajectory(jnp.asarray(est), loop_edges=loops)
        poses, cost = pg.optimize_pose_graph(graph, gn_iters=25, cg_iters=60)
        poses = np.asarray(poses)
        assert np.isfinite(poses).all()
        assert np.isfinite(float(cost))
        err_before = np.linalg.norm(est[-1][:3, 3] - gt[-1][:3, 3])
        err_after = np.linalg.norm(poses[-1][:3, 3] - gt[-1][:3, 3])
        assert err_after < 0.5 * err_before, (err_before, err_after)

    def test_single_pose_trajectory_raises(self):
        import pytest

        with pytest.raises(ValueError, match=">= 2 poses"):
            pg.from_trajectory(jnp.eye(4)[None])

    def test_explicit_odometry_measurements(self):
        """from_trajectory(odometry=...) must use the given measurements,
        not re-extract them from the (possibly optimized) poses."""
        gt, est, _ = _noisy_loop_trajectory(n=8, drift=0.03)
        n = len(est)
        odom = [
            (np.linalg.inv(est[i]) @ est[i + 1]).astype(np.float32)
            for i in range(n - 1)
        ]
        g_implicit = pg.from_trajectory(jnp.asarray(est))
        g_explicit = pg.from_trajectory(jnp.asarray(est), odometry=odom)
        np.testing.assert_allclose(
            np.asarray(g_explicit.measurements),
            np.asarray(g_implicit.measurements),
            atol=1e-5,
        )
        import pytest

        with pytest.raises(ValueError):
            pg.from_trajectory(jnp.asarray(est), odometry=odom[:-1])

    def test_downweighted_odometry_lets_loop_reanchor(self):
        """Per-edge odometry confidence: an edge that MISSED motion
        (tracking loss held the pose) drags the whole tail when weighted
        like clean odometry; down-weighted, the loop edge re-anchors the
        tail onto ground truth."""
        n = 10
        step = np.asarray(
            se3.exp(jnp.asarray([0.3, 0, 0, 0, 0, 0], jnp.float32))
        )
        gt = [np.eye(4, dtype=np.float32)]
        for _ in range(n - 1):
            gt.append((gt[-1] @ step).astype(np.float32))
        # Measured odometry: edge 4 saw NO motion (held pose).
        odom = [step.astype(np.float32)] * (n - 1)
        odom[4] = np.eye(4, dtype=np.float32)
        est = [np.eye(4, dtype=np.float32)]
        for T in odom:
            est.append((est[-1] @ T).astype(np.float32))
        est = np.stack(est[:n])
        T_loop = (np.linalg.inv(gt[0]) @ gt[-1]).astype(np.float32)
        loops = [(0, n - 1, T_loop, 2.0)]

        def solve(weights):
            g = pg.from_trajectory(
                jnp.asarray(est), loop_edges=loops, odometry=odom,
                odometry_weights=weights,
            )
            p, _ = pg.optimize_pose_graph(g, gn_iters=15, cg_iters=60)
            return np.linalg.norm(np.asarray(p)[-1][:3, 3] - gt[-1][:3, 3])

        err_flat = solve([1.0] * (n - 1))
        w = [1.0] * (n - 1)
        w[4] = 0.05
        err_weighted = solve(w)
        assert err_weighted < 0.5 * err_flat, (err_flat, err_weighted)
        assert err_weighted < 0.03

    def test_gauge_fixed(self):
        _, est, _ = _noisy_loop_trajectory()
        graph = pg.from_trajectory(jnp.asarray(est))
        poses, _ = pg.optimize_pose_graph(graph, gn_iters=2, cg_iters=10)
        np.testing.assert_allclose(np.asarray(poses[0]), np.eye(4), atol=1e-5)


class TestLoopClosureDetection:
    def _keyframe(self, seed, n=256):
        pts = jax.random.normal(jax.random.PRNGKey(seed), (n, 3), jnp.float32)
        feats = jax.random.uniform(jax.random.PRNGKey(seed + 100), (n, 33), jnp.float32)
        return cloud_mod.from_points(pts), feats

    def test_descriptor_normalized_and_deterministic(self):
        c, f = self._keyframe(0)
        d1 = np.asarray(global_descriptor(f, c.mask))
        d2 = np.asarray(global_descriptor(f, c.mask))
        np.testing.assert_array_equal(d1, d2)
        assert abs(np.linalg.norm(d1) - 1.0) < 1e-5

    def test_revisited_place_detected(self):
        db = KeyframeDatabase(min_separation=5, similarity_threshold=0.9)
        kfs = [self._keyframe(s) for s in range(6)]
        for i, (c, f) in enumerate(kfs):
            db.add(i, c, f)
        # Query with keyframe 0's content at a much later frame id.
        c0, f0 = kfs[0]
        hits = db.query(50, c0, f0)
        assert hits and hits[0][0] == 0
        assert hits[0][1] > 0.99

    def test_nearby_frames_excluded(self):
        db = KeyframeDatabase(min_separation=10)
        c, f = self._keyframe(1)
        db.add(0, c, f)
        assert db.query(5, c, f) == []  # too close in time

    def test_verification_produces_loop_edge(self):
        # Same cloud under a known transform with shared descriptors ->
        # verification must recover the transform.
        pts = jax.random.normal(jax.random.PRNGKey(2), (256, 3), jnp.float32)
        feats = jax.random.normal(jax.random.PRNGKey(3), (256, 33), jnp.float32)
        T_true = se3.exp(jnp.asarray([0.3, -0.2, 0.1, 0.5, 0.4, -0.3], jnp.float32))
        cloud_b = cloud_mod.from_points(pts)
        cloud_a = cloud_mod.from_points(se3.transform_points(T_true, pts))
        db = KeyframeDatabase(min_separation=1)
        db.add(0, cloud_b, feats)
        T_ab, ok = db.verify(30, cloud_a, feats, 0, noise_bound=0.1)
        assert ok
        err = np.abs(np.asarray(se3.log(se3.compose(se3.inverse(se3.inverse(T_true)), T_ab))))
        assert err.max() < 2e-2

    def test_200_keyframes_device_store_batched_verify(self):
        """Device-resident descriptor/cloud store at ~200
        keyframes (exercising capacity doubling), query still exact, and
        verify_batch resolves ALL candidates of a query in one vmapped
        dispatch with results identical to one-at-a-time verification."""
        db = KeyframeDatabase(
            min_separation=5, similarity_threshold=0.9, capacity=64
        )
        kfs = [self._keyframe(s, n=128) for s in range(200)]
        for i, (c, f) in enumerate(kfs):
            db.add(i, c, f)
        assert len(db) == 200
        assert db._desc.shape[0] >= 200  # grew past the initial 64 slots

        c0, f0 = kfs[0]
        hits = db.query(500, c0, f0)
        assert hits and hits[0][0] == 0 and hits[0][1] > 0.99

        cands = [0, 3, 17]
        batch = db.verify_batch(500, c0, f0, cands, noise_bound=0.1)
        assert len(batch) == 3
        for cid, (T_b, ok_b) in zip(cands, batch):
            T_s, ok_s = db.verify(500, c0, f0, cid, noise_bound=0.1)
            assert ok_b == ok_s
            if ok_b:
                # Transforms must agree only for ACCEPTED candidates:
                # rejected ones are GNC fits on unrelated clouds, which are
                # chaotic -- batch-size-dependent XLA reduction order
                # legitimately lands them on different (meaningless) fits.
                np.testing.assert_allclose(np.asarray(T_s), T_b, atol=1e-4)

        # Keyframe 0 vs its own content must verify as a loop (identity).
        T0, ok0 = batch[0]
        assert ok0
        assert np.abs(T0 - np.eye(4)).max() < 1e-2

        # pad_to caps the verified set (fixed program shape): extra
        # candidates are dropped, never compiled as a new batch size.
        capped = db.verify_batch(500, c0, f0, [0, 3, 17, 21, 42],
                                 noise_bound=0.1, pad_to=3)
        assert len(capped) == 3
        assert capped[0][1] == batch[0][1]


class TestLoopEdgeValidation:
    def test_out_of_range_loop_edge_raises(self):
        import pytest

        poses = jnp.stack([jnp.eye(4)] * 4)
        with pytest.raises(ValueError, match="out of range"):
            pg.from_trajectory(poses, loop_edges=[(0, 4, jnp.eye(4), 1.0)])
