"""Parity tests: the JAX ops vs the NumPy transcription of the C++ math.

These are the 1e-4 relative-pose agreement tests demanded by BASELINE.md.
"""

import jax
import jax.numpy as jnp
import numpy as np

from realsensetracker_tpu.align import icp as icp_mod
from realsensetracker_tpu.align import kabsch as kabsch_mod
from realsensetracker_tpu.geometry import se3
from realsensetracker_tpu.ops import cloud as cloud_mod
from realsensetracker_tpu.ops import correspond, normals

from tests import reference_impl as ref


def _random_cloud(key, n, scale=1.0):
    return scale * jax.random.normal(key, (n, 3), dtype=jnp.float32)


def _random_pose(key, rot_scale=0.2, trans_scale=0.3):
    tw = jax.random.normal(key, (6,), dtype=jnp.float32)
    tw = tw.at[:3].multiply(trans_scale).at[3:].multiply(rot_scale)
    return se3.exp(tw)


def pose_error(Ta, Tb):
    """Max abs difference over the 3x4 pose block."""
    return float(np.max(np.abs(np.asarray(Ta)[:3] - np.asarray(Tb)[:3])))


class TestKabschParity:
    def test_exact_rotation_recovered(self):
        src = _random_cloud(jax.random.PRNGKey(0), 50)
        T_true = _random_pose(jax.random.PRNGKey(1))
        dst = se3.transform_points(T_true, src)
        T = kabsch_mod.solve_kabsch(src, dst)
        assert pose_error(T, T_true) < 1e-4

    def test_matches_numpy_reference_weighted(self):
        key = jax.random.PRNGKey(2)
        src = _random_cloud(key, 40)
        T_true = _random_pose(jax.random.PRNGKey(3))
        dst = np.array(se3.transform_points(T_true, src))
        dst += 0.01 * np.random.RandomState(0).randn(*dst.shape).astype(np.float32)
        pairs = [(i, i) for i in range(40)]
        w = np.random.RandomState(1).rand(40).astype(np.float32)
        T_ref = ref.solve_kabsch_np(np.asarray(src), dst, pairs, w)
        T = kabsch_mod.solve_kabsch(src, jnp.asarray(dst), weights=jnp.asarray(w))
        assert pose_error(T, T_ref) < 1e-4

    def test_masked_matches_subset(self):
        src = _random_cloud(jax.random.PRNGKey(4), 30)
        T_true = _random_pose(jax.random.PRNGKey(5))
        dst = se3.transform_points(T_true, src)
        # Mask out half the pairs; golden runs on just the kept subset.
        keep = np.zeros(30, dtype=bool)
        keep[::2] = True
        pairs = [(i, i) for i in range(30) if keep[i]]
        T_ref = ref.solve_kabsch_np(np.asarray(src), np.asarray(dst), pairs)
        T = kabsch_mod.solve_kabsch(src, dst, mask=jnp.asarray(keep))
        assert pose_error(T, T_ref) < 1e-4

    def test_reflection_fix(self):
        # Degenerate planar cloud that can produce det<0 without the fix.
        src = np.random.RandomState(2).randn(20, 3).astype(np.float32)
        src[:, 2] = 0.0
        dst = src.copy()
        dst[:, 0] *= -1  # mirrored correspondence
        T = kabsch_mod.solve_kabsch(jnp.asarray(src), jnp.asarray(dst))
        R = np.asarray(se3.rotation(T))
        assert np.linalg.det(R) > 0


class TestNearestNeighborParity:
    def test_exact_1nn(self):
        src = np.asarray(_random_cloud(jax.random.PRNGKey(6), 257))
        dst_pts = np.asarray(_random_cloud(jax.random.PRNGKey(7), 123))
        dst = cloud_mod.from_points(jnp.asarray(dst_pts))
        idx, d2 = correspond.nearest_neighbors(jnp.asarray(src), dst, chunk=64)
        d2_full = ((src[:, None] - dst_pts[None]) ** 2).sum(-1)
        np.testing.assert_array_equal(np.asarray(idx), d2_full.argmin(1))
        np.testing.assert_allclose(np.asarray(d2), d2_full.min(1), rtol=1e-5, atol=1e-6)

    def test_masked_dst_excluded(self):
        dst_pts = jnp.array([[0.0, 0, 0], [10, 0, 0]], dtype=jnp.float32)
        dst = cloud_mod.Cloud(dst_pts, jnp.array([False, True]))
        idx, d2 = correspond.nearest_neighbors(
            jnp.array([[0.1, 0, 0]], dtype=jnp.float32), dst
        )
        assert int(idx[0]) == 1

    def test_knn_sorted_and_exact(self):
        src = np.asarray(_random_cloud(jax.random.PRNGKey(8), 65))
        dst_pts = np.asarray(_random_cloud(jax.random.PRNGKey(9), 90))
        dst = cloud_mod.from_points(jnp.asarray(dst_pts))
        idx, d2 = correspond.knn(jnp.asarray(src), dst, k=5, chunk=32)
        d2_full = ((src[:, None] - dst_pts[None]) ** 2).sum(-1)
        expect_idx = np.argsort(d2_full, axis=1)[:, :5]
        np.testing.assert_allclose(
            np.asarray(d2), np.take_along_axis(d2_full, expect_idx, 1), rtol=1e-5, atol=1e-6
        )


class TestIcpParity:
    def test_matches_numpy_reference(self):
        """Full GNC-ICP vs golden NumPy transcription: the BASELINE 1e-4 gate."""
        key = jax.random.PRNGKey(10)
        src_np = np.asarray(_random_cloud(key, 120))
        T_true = _random_pose(jax.random.PRNGKey(11), rot_scale=0.1, trans_scale=0.1)
        dst_np = np.asarray(se3.transform_points(T_true, jnp.asarray(src_np)))

        T_ref, cost_ref = ref.align_icp_np(src_np, dst_np, max_iter=32)
        res = icp_mod.align_icp(
            cloud_mod.from_points(jnp.asarray(src_np)),
            cloud_mod.from_points(jnp.asarray(dst_np)),
            max_iter=32,
        )
        assert pose_error(res.transform, T_ref) < 1e-4
        assert abs(float(res.mean_cost) - cost_ref) < 1e-4

    def test_recovers_known_transform(self):
        src = _random_cloud(jax.random.PRNGKey(12), 200, scale=2.0)
        T_true = _random_pose(jax.random.PRNGKey(13), rot_scale=0.05, trans_scale=0.05)
        dst = se3.transform_points(T_true, src)
        res = icp_mod.align_icp(
            cloud_mod.from_points(src), cloud_mod.from_points(dst), max_iter=64
        )
        assert pose_error(res.transform, T_true) < 1e-3
        assert bool(res.success)

    def test_masked_points_ignored(self):
        src = _random_cloud(jax.random.PRNGKey(14), 100)
        T_true = _random_pose(jax.random.PRNGKey(15), rot_scale=0.05, trans_scale=0.05)
        dst = se3.transform_points(T_true, src)
        # Add garbage points masked out of src; result must match golden on
        # the valid subset only.
        src_aug = jnp.concatenate([src, 100.0 + _random_cloud(jax.random.PRNGKey(16), 28)])
        mask = jnp.concatenate([jnp.ones(100, bool), jnp.zeros(28, bool)])
        res = icp_mod.align_icp(
            cloud_mod.Cloud(src_aug, mask), cloud_mod.from_points(dst), max_iter=32
        )
        T_ref, _ = ref.align_icp_np(np.asarray(src), np.asarray(dst), max_iter=32)
        assert pose_error(res.transform, T_ref) < 1e-4


class TestNormalsParity:
    def test_plane_normals(self):
        key = jax.random.PRNGKey(17)
        xy = jax.random.uniform(key, (200, 2), dtype=jnp.float32)
        pts = jnp.concatenate([xy, jnp.full((200, 1), 2.0)], axis=-1)
        c = cloud_mod.from_points(pts)
        n = normals.knn_pca_normals(c, k=16)
        n = normals.orient_normals(pts, n, jnp.zeros(3))
        np.testing.assert_allclose(
            np.asarray(n), np.tile([0, 0, -1.0], (200, 1)), atol=1e-3
        )

    def test_matches_numpy_reference(self):
        pts = np.asarray(_random_cloud(jax.random.PRNGKey(18), 60))
        n_ref = ref.compute_normals_np(pts, k=8)
        c = cloud_mod.from_points(jnp.asarray(pts))
        n = np.asarray(normals.knn_pca_normals(c, k=8))
        # Eigenvector sign is arbitrary: compare up to sign.
        dots = np.abs((n * n_ref).sum(-1))
        np.testing.assert_allclose(dots, 1.0, atol=1e-3)
