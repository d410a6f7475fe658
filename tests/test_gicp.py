"""GICP tests: covariance parity with the C++ semantics + pose recovery."""

import jax
import jax.numpy as jnp
import numpy as np

from realsensetracker_tpu.align import gicp as gicp_mod
from realsensetracker_tpu.geometry import se3
from realsensetracker_tpu.ops import cloud as cloud_mod
from tests import reference_impl


def _random_cloud(key, n, scale=1.0):
    return scale * jax.random.normal(key, (n, 3), dtype=jnp.float32)


def _covariances_np(points, k=8, use_gicp=False):
    """Scalar transcription of ComputeCovariances (point_cloud_utils.cpp:
    100-161): k+1 NN, skip self, centroid over k, scatter, /(k-1) or
    singular-value remap."""
    points = np.asarray(points, np.float32)
    n = len(points)
    d2 = ((points[:, None] - points[None]) ** 2).sum(-1)
    covs = np.zeros((n, 3, 3), np.float32)
    for i in range(n):
        idx = np.argsort(d2[i], kind="stable")[1 : k + 1]  # skip self
        nb = points[idx]
        ctr = nb.mean(0)
        cov = np.zeros((3, 3), np.float32)
        for p in nb:
            cov += np.outer(p - ctr, p - ctr)
        if use_gicp:
            u, s, _ = np.linalg.svd(cov)
            cov = np.zeros((3, 3), np.float32)
            for kk in range(3):
                v = 1.0 if kk < 2 else 1e-2
                cov += v * np.outer(u[:, kk], u[:, kk])
        else:
            cov /= k - 1
        covs[i] = cov
    return covs


class TestCovariances:
    def test_plain_covariance_parity(self):
        pts = np.asarray(_random_cloud(jax.random.PRNGKey(0), 40))
        ref = _covariances_np(pts, k=8, use_gicp=False)
        got = np.asarray(
            gicp_mod.compute_covariances(
                cloud_mod.from_points(jnp.asarray(pts)), k=8, use_gicp=False
            )
        )
        np.testing.assert_allclose(got, ref, atol=1e-5)

    def test_sparse_cloud_ignores_phantom_neighbors(self):
        """Fewer valid points than cov_k: the padded _BIG-distance
        neighbors land on masked zero rows and used to drag every
        covariance toward the origin; they must carry zero weight."""
        rng = np.random.RandomState(3)
        pts5 = (rng.rand(5, 3) * 0.2 + 1.0).astype(np.float32)
        cap = 64
        padded = np.zeros((cap, 3), np.float32)
        padded[:5] = pts5
        mask = np.zeros(cap, bool)
        mask[:5] = True
        got = np.asarray(
            gicp_mod.compute_covariances(
                cloud_mod.Cloud(jnp.asarray(padded), jnp.asarray(mask)),
                k=8, use_gicp=False,
            )
        )[:5]
        # Oracle over the 4 REAL neighbors of each of the 5 points
        # (self excluded), scatter / (count - 1).
        for i in range(5):
            nb = np.array([pts5[j] for j in range(5) if j != i])
            ctr = nb.mean(0)
            cov = sum(np.outer(p - ctr, p - ctr) for p in nb) / (4 - 1)
            np.testing.assert_allclose(got[i], cov, atol=1e-5)

    def test_gicp_covariance_parity(self):
        pts = np.asarray(_random_cloud(jax.random.PRNGKey(1), 40))
        ref = _covariances_np(pts, k=8, use_gicp=True)
        got = np.asarray(
            gicp_mod.compute_covariances(
                cloud_mod.from_points(jnp.asarray(pts)), k=8, use_gicp=True
            )
        )
        np.testing.assert_allclose(got, ref, atol=1e-4)

    def test_gicp_covariance_eigenvalues(self):
        pts = _random_cloud(jax.random.PRNGKey(2), 30)
        covs = gicp_mod.compute_covariances(
            cloud_mod.from_points(pts), k=8, use_gicp=True
        )
        vals = np.linalg.eigvalsh(np.asarray(covs))
        np.testing.assert_allclose(vals[:, 2], 1.0, atol=1e-4)
        np.testing.assert_allclose(vals[:, 0], 1e-2, atol=1e-4)


class TestGicpAlignment:
    def test_recovers_exact_transform(self):
        src = _random_cloud(jax.random.PRNGKey(3), 120)
        T_true = se3.exp(
            jnp.array([0.05, -0.03, 0.04, 0.04, -0.03, 0.05], jnp.float32)
        )
        dst = se3.transform_points(T_true, src)
        res = gicp_mod.align_gicp(
            cloud_mod.from_points(src), cloud_mod.from_points(dst),
            max_outer=8, inner_iters=8, cov_k=8,
        )
        err = np.abs(np.asarray(se3.log(se3.compose(se3.inverse(T_true), res.transform))))
        assert err.max() < 1e-4

    def test_gicp_cov_variant_recovers(self):
        src = _random_cloud(jax.random.PRNGKey(4), 100)
        T_true = se3.exp(jnp.array([0.02, 0.03, -0.02, -0.03, 0.02, 0.02], jnp.float32))
        dst = se3.transform_points(T_true, src)
        res = gicp_mod.align_gicp(
            cloud_mod.from_points(src), cloud_mod.from_points(dst),
            max_outer=8, inner_iters=8, cov_k=8, use_gicp_cov=True,
        )
        err = np.abs(np.asarray(se3.log(se3.compose(se3.inverse(T_true), res.transform))))
        assert err.max() < 1e-3

    def test_cost_evaluated_at_returned_transform(self):
        """GicpResult.cost follows the Ceres final_cost convention: it is
        the cost AT the returned transform, not one GN step behind it."""
        src = np.asarray(_random_cloud(jax.random.PRNGKey(7), 48))
        T_true = se3.exp(jnp.array([0.03, -0.02, 0.02, 0.02, 0.01, -0.02],
                                   jnp.float32))
        dst = np.asarray(se3.transform_points(T_true, jnp.asarray(src)))
        covs = jnp.tile(jnp.eye(3, dtype=jnp.float32)[None] * 1e-2, (48, 1, 1))
        mask = jnp.ones(48, bool)
        T, c = gicp_mod.solve_alignment(
            jnp.asarray(src), jnp.asarray(dst), covs, covs, mask,
            seed=se3.identity(), inner_iters=4,
        )
        # inner_iters=0 evaluates the cost at the seed without stepping.
        T0, c0 = gicp_mod.solve_alignment(
            jnp.asarray(src), jnp.asarray(dst), covs, covs, mask,
            seed=T, inner_iters=0,
        )
        np.testing.assert_array_equal(np.asarray(T0), np.asarray(T))
        np.testing.assert_allclose(float(c), float(c0), rtol=1e-6)

    def test_huber_rejects_outliers(self):
        key = jax.random.PRNGKey(5)
        src = _random_cloud(key, 100)
        T_true = se3.exp(jnp.array([0.03, 0, 0, 0, 0.03, 0], jnp.float32))
        dst = np.array(se3.transform_points(T_true, src))
        dst[:10] += 5.0  # corrupt 10% of destinations
        res = gicp_mod.align_gicp(
            cloud_mod.from_points(src), cloud_mod.from_points(jnp.asarray(dst)),
            max_outer=8, inner_iters=8, cov_k=8,
        )
        err = np.abs(np.asarray(se3.log(se3.compose(se3.inverse(T_true), res.transform))))
        assert err.max() < 5e-2

    def test_golden_parity_inner_solve(self):
        """Pin solve_alignment to the NumPy transcription of the C++ math
        (gicp_cost.hpp:40-73 whitened residual + Huber(0.5) IRLS,
        align_gicp.cpp:41-103): noisy correspondences + outliers make the
        optimum depend on the Huber weighting and whitening-update order,
        so any semantic change breaks the 1e-4 agreement."""
        rng = np.random.RandomState(11)
        n = 60
        src = rng.randn(n, 3).astype(np.float32)
        T_true = np.asarray(
            se3.exp(jnp.array([0.04, -0.02, 0.03, 0.03, -0.02, 0.04], jnp.float32))
        )
        dst = src @ T_true[:3, :3].T + T_true[:3, 3]
        dst += 0.01 * rng.randn(n, 3).astype(np.float32)
        dst[:6] += 2.0  # outliers: exercise the Huber branch
        src_covs = reference_impl.compute_covariances_np(src, k=8)
        dst_covs = reference_impl.compute_covariances_np(dst, k=8)
        seed = np.eye(4, dtype=np.float32)

        T_ref, cost_ref = reference_impl.gicp_solve_np(
            src, dst, src_covs, dst_covs, seed, inner_iters=6
        )
        T_jax, cost_jax = gicp_mod.solve_alignment(
            jnp.asarray(src),
            jnp.asarray(dst),
            jnp.asarray(src_covs, jnp.float32),
            jnp.asarray(dst_covs, jnp.float32),
            jnp.ones(n, bool),
            jnp.asarray(seed),
            inner_iters=6,
        )
        err = np.abs(
            np.asarray(se3.log(se3.compose(se3.inverse(jnp.asarray(T_ref)), T_jax)))
        )
        assert err.max() < 1e-4, err
        np.testing.assert_allclose(float(cost_jax), float(cost_ref), rtol=1e-3)

    def test_golden_parity_full_gicp(self):
        """Pin align_gicp end-to-end (outer correspondence rounds included,
        align_gicp.cpp:105-163) to the NumPy oracle at 1e-4."""
        rng = np.random.RandomState(12)
        n = 50
        src = rng.randn(n, 3).astype(np.float32)
        T_true = np.asarray(
            se3.exp(jnp.array([0.03, 0.02, -0.03, -0.02, 0.03, 0.02], jnp.float32))
        )
        dst = src @ T_true[:3, :3].T + T_true[:3, 3]
        dst += 0.005 * rng.randn(n, 3).astype(np.float32)

        T_ref, _ = reference_impl.align_gicp_np(
            src, dst, max_outer=6, inner_iters=4, cov_k=8
        )
        res = gicp_mod.align_gicp(
            cloud_mod.from_points(jnp.asarray(src)),
            cloud_mod.from_points(jnp.asarray(dst)),
            max_outer=6, inner_iters=4, cov_k=8,
        )
        err = np.abs(
            np.asarray(
                se3.log(se3.compose(se3.inverse(jnp.asarray(T_ref)), res.transform))
            )
        )
        assert err.max() < 1e-4, err

    def test_masked_points_ignored(self):
        src = _random_cloud(jax.random.PRNGKey(6), 80)
        T_true = se3.exp(jnp.array([0.02, -0.02, 0.02, 0.02, 0.02, -0.02], jnp.float32))
        dst = se3.transform_points(T_true, src)
        src_aug = jnp.concatenate([src, 50.0 + _random_cloud(jax.random.PRNGKey(7), 20)])
        mask = jnp.concatenate([jnp.ones(80, bool), jnp.zeros(20, bool)])
        res = gicp_mod.align_gicp(
            cloud_mod.Cloud(src_aug, mask), cloud_mod.from_points(dst),
            max_outer=8, inner_iters=8, cov_k=8,
        )
        err = np.abs(np.asarray(se3.log(se3.compose(se3.inverse(T_true), res.transform))))
        assert err.max() < 1e-3


class TestAutodiffWhitening:
    """Differentiate THROUGH the whitening (like Ceres's Jet
    evaluation of gicp_cost.hpp:57-68) and quantify the step-direction
    difference vs the fixed-W scheme on anisotropic covariances."""

    def _aniso_problem(self, seed=0, n=200):
        rng = np.random.RandomState(seed)
        src = rng.randn(n, 3).astype(np.float32)
        T_true = se3.exp(
            jnp.array([0.04, -0.03, 0.05, 0.05, -0.04, 0.03], jnp.float32)
        )
        dst = np.asarray(se3.transform_points(T_true, jnp.asarray(src)))

        def rand_covs():
            covs = np.zeros((n, 3, 3), np.float32)
            for i in range(n):
                q, _ = np.linalg.qr(rng.randn(3, 3))
                # Strongly anisotropic: plane-like neighborhoods.
                covs[i] = q @ np.diag([1.0, 0.1, 1e-3]) @ q.T
            return jnp.asarray(covs)

        mask = jnp.ones(n, bool)
        return (
            jnp.asarray(src), jnp.asarray(dst), rand_covs(), rand_covs(),
            mask, T_true,
        )

    def test_whitening_jvp_finite_differences(self):
        rng = np.random.RandomState(3)
        a = rng.randn(5, 3, 3).astype(np.float64)
        M = jnp.asarray(a @ a.transpose(0, 2, 1) + 0.1 * np.eye(3))
        dM_a = rng.randn(5, 3, 3)
        dM = jnp.asarray((dM_a + dM_a.transpose(0, 2, 1)) / 2)
        _, got = jax.jvp(gicp_mod._whitening_diff, (M,), (dM,))
        eps = 1e-6
        fd = (gicp_mod._whitening(M + eps * dM) - gicp_mod._whitening(M - eps * dM)) / (
            2 * eps
        )
        np.testing.assert_allclose(np.asarray(got), np.asarray(fd), atol=1e-4)

    def test_whitening_jvp_repeated_eigenvalues_finite(self):
        # eigh's builtin JVP blows up here; the Daleckii-Krein form must not.
        # f64 so the finite-difference reference is not noise-limited.
        M = jnp.asarray(np.stack([np.eye(3) * 2.0]))
        dM = jnp.asarray(np.ones((1, 3, 3)) * 0.1)
        _, got = jax.jvp(gicp_mod._whitening_diff, (M,), (dM,))
        assert np.all(np.isfinite(np.asarray(got)))
        # At M = 2I the exact derivative is f'(2) dM = -0.5 * 2^{-3/2} dM.
        exact = -0.5 * 2.0 ** (-1.5) * np.asarray(dM)
        np.testing.assert_allclose(np.asarray(got), exact, atol=1e-6)
        eps = 1e-6
        fd = (gicp_mod._whitening(M + eps * dM) - gicp_mod._whitening(M - eps * dM)) / (
            2 * eps
        )
        np.testing.assert_allclose(np.asarray(got), np.asarray(fd), atol=1e-5)

    def test_step_directions_differ_but_converge_identically(self):
        src, dst, cs, cd, mask, T_true = self._aniso_problem()

        # ONE Gauss-Newton step from identity: the directions must actually
        # differ (the dW term is real) but stay within the same half-space.
        T_fix, _ = gicp_mod.solve_alignment(
            src, dst, cs, cd, mask, se3.identity(), inner_iters=1,
        )
        T_auto, _ = gicp_mod.solve_alignment(
            src, dst, cs, cd, mask, se3.identity(), inner_iters=1,
            whitening="autodiff",
        )
        tw_f = np.asarray(se3.log(T_fix))
        tw_a = np.asarray(se3.log(T_auto))
        cos = float(
            tw_f @ tw_a / (np.linalg.norm(tw_f) * np.linalg.norm(tw_a))
        )
        angle_deg = np.degrees(np.arccos(np.clip(cos, -1, 1)))
        assert angle_deg > 0.01  # the whitening derivative changes the step
        assert angle_deg < 30.0  # ...but not its character (measured ~2-6 deg)

        # Shared fixed point: both reach T_true, final transforms agree.
        T_fix8, _ = gicp_mod.solve_alignment(
            src, dst, cs, cd, mask, se3.identity(), inner_iters=12,
        )
        T_auto8, _ = gicp_mod.solve_alignment(
            src, dst, cs, cd, mask, se3.identity(), inner_iters=12,
            whitening="autodiff",
        )
        for T in (T_fix8, T_auto8):
            err = np.abs(
                np.asarray(se3.log(se3.compose(se3.inverse(T_true), T)))
            )
            assert err.max() < 1e-4
        diff = np.abs(
            np.asarray(se3.log(se3.compose(se3.inverse(T_fix8), T_auto8)))
        )
        assert diff.max() < 1e-5

    def test_align_gicp_autodiff_golden_parity(self):
        """End-to-end align_gicp with autodiff whitening still matches the
        golden NumPy oracle (same fixed points as fixed-W)."""
        rng = np.random.RandomState(15)
        n = 50
        src = rng.randn(n, 3).astype(np.float32)
        T_true = np.asarray(
            se3.exp(jnp.array([0.03, 0.02, -0.03, -0.02, 0.03, 0.02], jnp.float32))
        )
        dst = src @ T_true[:3, :3].T + T_true[:3, 3]

        T_ref, _ = reference_impl.align_gicp_np(
            src, dst, max_outer=6, inner_iters=4, cov_k=8
        )
        res = gicp_mod.align_gicp(
            cloud_mod.from_points(jnp.asarray(src)),
            cloud_mod.from_points(jnp.asarray(dst)),
            max_outer=6, inner_iters=4, cov_k=8, whitening="autodiff",
        )
        err = np.abs(
            np.asarray(
                se3.log(se3.compose(se3.inverse(jnp.asarray(T_ref)), res.transform))
            )
        )
        assert err.max() < 1e-3, err
