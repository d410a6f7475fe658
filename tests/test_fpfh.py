"""FPFH parity tests vs the NumPy transcription of fpfh.cpp."""

import jax
import jax.numpy as jnp
import numpy as np

from realsensetracker_tpu.ops import cloud as cloud_mod
from realsensetracker_tpu.ops import fpfh as fpfh_mod
from realsensetracker_tpu.ops import normals as normals_mod

from tests import reference_impl as ref


def _cloud_and_normals(n=60, seed=0):
    pts = np.asarray(
        0.5 * jax.random.normal(jax.random.PRNGKey(seed), (n, 3), dtype=jnp.float32)
    )
    c = cloud_mod.from_points(jnp.asarray(pts))
    nrm = normals_mod.knn_pca_normals(c, k=8)
    nrm = normals_mod.orient_normals(c.points, nrm, jnp.zeros(3))
    return pts, c, np.asarray(nrm)


class TestPairFeatures:
    def test_matches_reference_pairs(self):
        rng = np.random.RandomState(0)
        for _ in range(50):
            p1, p2 = rng.randn(3).astype(np.float32), rng.randn(3).astype(np.float32)
            n1 = rng.randn(3).astype(np.float32)
            n2 = rng.randn(3).astype(np.float32)
            n1 /= np.linalg.norm(n1)
            n2 /= np.linalg.norm(n2)
            f_ref, ok_ref = ref.compute_pfh_np(p1, n1, p2, n2)
            f, ok = fpfh_mod.pair_features(
                jnp.asarray(p1), jnp.asarray(n1), jnp.asarray(p2), jnp.asarray(n2)
            )
            assert bool(ok) == ok_ref
            if ok_ref:
                np.testing.assert_allclose(np.asarray(f), f_ref, atol=1e-5)

    def test_zero_distance_invalid(self):
        p = jnp.ones(3)
        n = jnp.array([1.0, 0, 0])
        _, ok = fpfh_mod.pair_features(p, n, p, n)
        assert not bool(ok)


class TestFpfhParity:
    def test_matches_numpy_reference(self):
        pts, c, nrm = _cloud_and_normals(n=50)
        radius = 0.8
        f_ref = ref.compute_fpfh_np(pts, nrm, radius)
        f = np.asarray(
            fpfh_mod.compute_fpfh_from_normals(
                c, jnp.asarray(nrm), radius, max_neighbors=50
            )
        )
        np.testing.assert_allclose(f, f_ref, atol=1e-4)

    def test_histogram_sums(self):
        pts, c, nrm = _cloud_and_normals(n=40, seed=1)
        f = np.asarray(
            fpfh_mod.compute_fpfh_from_normals(c, jnp.asarray(nrm), 0.8, max_neighbors=40)
        )
        seg = f.reshape(-1, 3, 11).sum(-1)
        # Each segment sums to 1 (or 0 for isolated points).
        assert np.all((np.abs(seg - 1.0) < 1e-4) | (seg < 1e-6))

    def test_capped_neighbors_still_close(self):
        # With a cap below the true ball size the features approximate;
        # sanity: no NaNs and roughly normalized.
        pts, c, nrm = _cloud_and_normals(n=60, seed=2)
        f = np.asarray(
            fpfh_mod.compute_fpfh_from_normals(c, jnp.asarray(nrm), 1.5, max_neighbors=16)
        )
        assert np.all(np.isfinite(f))


class TestBallCapDetection:
    """A ball denser than the kNN cap is DETECTED, and the
    auto-sized cap restores exact radiusSearch parity (fpfh.cpp:133-147)."""

    def _dense_cloud(self, n_dense=100, n_far=20, seed=7):
        rng = np.random.RandomState(seed)
        # n_dense points packed inside a 0.2-radius ball (all mutually within
        # the 0.5 feature radius) + a sparse shell far outside it.
        dense = 0.1 * rng.randn(n_dense, 3).astype(np.float32)
        dense = np.clip(dense, -0.2, 0.2)
        far = 5.0 + rng.rand(n_far, 3).astype(np.float32)
        pts = np.vstack([dense, far])
        return pts, cloud_mod.from_points(jnp.asarray(pts))

    def test_truncation_detected(self):
        pts, c = self._dense_cloud()
        radius = 0.5
        assert fpfh_mod.densest_ball_count(c, radius) >= 100
        assert fpfh_mod.ball_truncated(c, radius, 64)  # default cap: too small
        assert not fpfh_mod.ball_truncated(c, radius, 128)

    def test_ball_counts_match_bruteforce(self):
        pts, c = self._dense_cloud(n_dense=30, n_far=10, seed=8)
        radius = 0.5
        d2 = ((pts[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
        expect = (d2 <= radius * radius).sum(-1)
        got = np.asarray(fpfh_mod.ball_counts(c, radius, chunk=16))
        np.testing.assert_array_equal(got, expect)

    def test_auto_cap_restores_exact_parity(self):
        pts, c = self._dense_cloud()
        radius = 0.5
        nrm = normals_mod.knn_pca_normals(c, k=8)
        nrm = normals_mod.orient_normals(c.points, nrm, jnp.zeros(3))
        k_auto = fpfh_mod.auto_max_neighbors((c, radius))
        assert k_auto >= fpfh_mod.densest_ball_count(c, radius)
        f_auto = np.asarray(
            fpfh_mod.compute_fpfh_from_normals(c, nrm, radius, max_neighbors=k_auto)
        )
        f_ref = ref.compute_fpfh_np(pts, np.asarray(nrm), radius)
        np.testing.assert_allclose(f_auto, f_ref, atol=1e-4)
        # The truncating default cap demonstrably drifts on this cloud --
        # the silent failure mode the detection exists for.
        f_cap = np.asarray(
            fpfh_mod.compute_fpfh_from_normals(c, nrm, radius, max_neighbors=64)
        )
        assert float(np.abs(f_cap - f_ref).max()) > 1e-3

    def test_align_pair_auto_mode(self):
        from realsensetracker_tpu.api.config import AlignConfig
        from realsensetracker_tpu.models.pairwise import align_pair

        pts, c = self._dense_cloud(n_dense=60, n_far=20, seed=9)
        cfg = AlignConfig(
            fpfh_max_neighbors=0,  # auto
            voxel_size=0.01,
            refine_with_icp=False,
            cloud_capacity=128,
        )
        res = align_pair(c, c, cfg)
        assert res.success


class TestMatching:
    def test_knn_feature_matching(self):
        # Well-separated random 33-D features: self-match must come first.
        rng = np.random.RandomState(3)
        f = jnp.asarray(rng.rand(40, 33).astype(np.float32) * 4.0)
        mask = jnp.ones(40, bool)
        idx, d2 = fpfh_mod.compute_matches(f, f, mask, mask, num_matches=2)
        np.testing.assert_array_equal(np.asarray(idx[:, 0]), np.arange(40))
        assert float(jnp.max(d2[:, 0])) < 1e-3

    def test_lowe_pruning_matches_reference(self):
        rng = np.random.RandomState(4)
        src_f = rng.rand(30, 33).astype(np.float32)
        dst_f = rng.rand(25, 33).astype(np.float32)
        idx, _ = fpfh_mod.compute_matches(
            jnp.asarray(src_f), jnp.asarray(dst_f),
            jnp.ones(30, bool), jnp.ones(25, bool), 2,
        )
        pairs_ref, w_ref = ref.prune_matches_lowe_np(np.asarray(idx), src_f, dst_f, 0.9)
        j, w, keep = fpfh_mod.prune_matches_lowe(
            idx, jnp.asarray(src_f), jnp.asarray(dst_f), 0.9
        )
        got = [(i, int(j[i])) for i in range(30) if bool(keep[i])]
        assert got == pairs_ref
        got_w = [float(w[i]) for i in range(30) if bool(keep[i])]
        np.testing.assert_allclose(got_w, w_ref, rtol=1e-5)

    def test_plane_vs_sphere_features_differ(self):
        # Discriminability sanity: FPFH of a plane differs from a sphere.
        n = 80
        rng = np.random.RandomState(5)
        plane = np.c_[rng.rand(n, 2), np.zeros(n)].astype(np.float32)
        theta = rng.rand(n) * np.pi
        phi = rng.rand(n) * 2 * np.pi
        sphere = 0.5 * np.c_[
            np.sin(theta) * np.cos(phi), np.sin(theta) * np.sin(phi), np.cos(theta)
        ].astype(np.float32)
        fp = np.asarray(
            fpfh_mod.compute_fpfh(cloud_mod.from_points(jnp.asarray(plane)), jnp.asarray([0, 0, -5.0]), 8, 0.5, 64)
        )
        fs = np.asarray(
            fpfh_mod.compute_fpfh(cloud_mod.from_points(jnp.asarray(sphere)), jnp.asarray([0, 0, -5.0]), 8, 0.5, 64)
        )
        assert np.linalg.norm(fp.mean(0) - fs.mean(0)) > 0.1
