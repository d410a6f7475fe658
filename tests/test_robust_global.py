"""Robust global registration (GNC-TLS): large-motion recovery with outliers,
the regime where local ICP fails (ref TEASER usage, rs_align_app.cpp:310-314)."""

import jax
import jax.numpy as jnp
import numpy as np

from realsensetracker_tpu.align import robust_global
from realsensetracker_tpu.geometry import se3
from realsensetracker_tpu.ops import cloud as cloud_mod


def _scene(key, n=256, scale=1.0):
    return scale * jax.random.normal(key, (n, 3), dtype=jnp.float32)


def _feats_from_identity(n, noise, key):
    """Synthetic descriptors: matched points share a descriptor up to noise."""
    base = jax.random.normal(key, (n, 33), dtype=jnp.float32)
    return base, base + noise * jax.random.normal(jax.random.PRNGKey(99), (n, 33), dtype=jnp.float32)


def _twist_err(T_est, T_true):
    return float(np.abs(np.asarray(se3.log(se3.compose(se3.inverse(T_true), T_est)))).max())


class TestMutualMatches:
    def test_perfect_features_match_identity(self):
        f = jax.random.normal(jax.random.PRNGKey(0), (50, 33), dtype=jnp.float32)
        mask = jnp.ones(50, bool)
        idx, keep = robust_global.mutual_matches(f, f, mask, mask)
        np.testing.assert_array_equal(np.asarray(idx), np.arange(50))
        assert bool(jnp.all(keep))

    def test_cross_check_kills_asymmetric(self):
        # dst has a decoy very close to src feature 0's nearest, breaking
        # mutual consistency for it.
        src_f = jnp.asarray(np.eye(4, 33, dtype=np.float32) * 3)
        dst_rows = np.eye(4, 33, dtype=np.float32) * 3
        dst_rows[0] = dst_rows[1] * 0.99  # dst 0 sits next to src 1's match
        idx, keep = robust_global.mutual_matches(
            src_f, jnp.asarray(dst_rows), jnp.ones(4, bool), jnp.ones(4, bool)
        )
        assert not bool(jnp.all(keep))


def _numpy_max_kcore(adj: np.ndarray, keep: np.ndarray) -> np.ndarray:
    """Exact maximum k-core by sequential peeling (test oracle)."""
    adj = adj & ~np.eye(len(keep), dtype=bool) & keep[:, None] & keep[None, :]
    best = keep.copy()
    for k in range(1, len(keep) + 1):
        alive = keep.copy()
        while True:
            deg = (adj & alive[None, :]).sum(-1)
            new = alive & (deg >= k)
            if (new == alive).all():
                break
            alive = new
        if not alive.any():
            break
        best = alive
    return best


def _numpy_max_clique(adj: np.ndarray, keep: np.ndarray) -> set:
    """Bron-Kerbosch with pivoting (exact; small graphs only) --
    PMC_EXACT stand-in oracle (teaser_interface.cpp:92-94)."""
    n = len(keep)
    adj = adj & ~np.eye(n, dtype=bool) & keep[:, None] & keep[None, :]
    nbrs = [set(np.nonzero(adj[i])[0].tolist()) for i in range(n)]
    best: list[set] = [set()]

    def bk(r, p, x):
        if not p and not x:
            if len(r) > len(best[0]):
                best[0] = set(r)
            return
        pivot = max(p | x, key=lambda v: len(nbrs[v] & p))
        for v in list(p - nbrs[pivot]):
            bk(r | {v}, p & nbrs[v], x & nbrs[v])
            p.discard(v)
            x.add(v)

    bk(set(), set(np.nonzero(keep)[0].tolist()), set())
    return best[0]


class TestMaxKcore:
    def _random_graph(self, seed, n=48, p=0.2):
        rng = np.random.RandomState(seed)
        a = rng.rand(n, n) < p
        adj = a | a.T
        keep = rng.rand(n) < 0.9
        return adj, keep

    def test_matches_sequential_peeling_oracle(self):
        for seed in range(5):
            adj, keep = self._random_graph(seed)
            got = np.asarray(
                jax.jit(robust_global.max_kcore)(jnp.asarray(adj), jnp.asarray(keep))
            )
            np.testing.assert_array_equal(got, _numpy_max_kcore(adj, keep))

    def test_contains_max_clique(self):
        # Any clique of size c lives in the (c-1)-core, so the max clique
        # must survive peeling whenever its size-1 >= the graph degeneracy.
        rng = np.random.RandomState(7)
        n = 40
        adj = rng.rand(n, n) < 0.1
        adj |= adj.T
        clique = rng.choice(n, 12, replace=False)
        adj[np.ix_(clique, clique)] = True
        keep = np.ones(n, bool)
        core = np.asarray(
            robust_global.max_kcore(jnp.asarray(adj), jnp.asarray(keep))
        )
        max_clique = _numpy_max_clique(adj, keep)
        assert max_clique == set(clique.tolist())
        assert max_clique <= set(np.nonzero(core)[0].tolist())

    def test_empty_keep(self):
        adj = np.ones((8, 8), bool)
        core = np.asarray(
            robust_global.max_kcore(jnp.asarray(adj), jnp.zeros(8, bool))
        )
        assert not core.any()


class TestRobustRegistration:
    def test_large_rotation_recovered(self):
        src = _scene(jax.random.PRNGKey(1))
        # 90-degree-scale motion: far outside local ICP's basin.
        T_true = se3.exp(jnp.array([0.5, -0.3, 0.2, 1.2, 0.8, -0.5], jnp.float32))
        dst = se3.transform_points(T_true, src)
        sf, df = _feats_from_identity(256, 0.01, jax.random.PRNGKey(2))
        res = robust_global.register_robust(
            cloud_mod.from_points(src), cloud_mod.from_points(dst), sf, df, 0.1
        )
        assert bool(res.valid)
        assert _twist_err(res.transform, T_true) < 1e-2

    def test_outlier_correspondences_rejected(self):
        key = jax.random.PRNGKey(3)
        src = _scene(key)
        T_true = se3.exp(jnp.array([0.3, 0.2, -0.4, 0.9, -0.6, 0.4], jnp.float32))
        dst = np.array(se3.transform_points(T_true, src))
        # Corrupt 30% of destination points -> gross outlier matches.
        rng = np.random.RandomState(0)
        bad = rng.choice(256, 77, replace=False)
        dst[bad] = rng.randn(77, 3) * 3
        sf, df = _feats_from_identity(256, 0.01, jax.random.PRNGKey(4))
        res = robust_global.register_robust(
            cloud_mod.from_points(src), cloud_mod.from_points(jnp.asarray(dst)), sf, df, 0.1
        )
        assert bool(res.valid)
        assert _twist_err(res.transform, T_true) < 5e-2

    def test_noise_tolerance(self):
        src = _scene(jax.random.PRNGKey(5))
        T_true = se3.exp(jnp.array([0.2, -0.1, 0.3, 0.7, 0.5, -0.3], jnp.float32))
        dst = se3.transform_points(T_true, src)
        dst = dst + 0.01 * jax.random.normal(jax.random.PRNGKey(6), dst.shape, dtype=jnp.float32)
        sf, df = _feats_from_identity(256, 0.01, jax.random.PRNGKey(7))
        res = robust_global.register_robust(
            cloud_mod.from_points(src), cloud_mod.from_points(dst), sf, df, 0.1
        )
        assert _twist_err(res.transform, T_true) < 5e-2

    def test_structured_outliers_60pct(self):
        """>=60% outliers arranged as three internally-consistent decoy
        groups (each moved by its own rigid transform). Every decoy group is
        a clique of ~half the inlier clique's size: the round-2 one-shot
        degree screen admits all of them, while max-k-core peeling isolates
        the true inlier set and registration recovers the true motion."""
        n, n_in = 256, 102
        key = jax.random.PRNGKey(20)
        src = np.asarray(_scene(key, n=n))
        T_true = se3.exp(jnp.array([0.4, -0.2, 0.3, 0.8, -0.5, 0.6], jnp.float32))
        dst = np.array(se3.transform_points(T_true, jnp.asarray(src)))
        decoys = [
            se3.exp(jnp.array(t, jnp.float32))
            for t in (
                [-0.5, 0.3, 0.1, -1.0, 0.4, 0.2],
                [0.1, 0.6, -0.4, 0.3, 1.1, -0.7],
                [0.7, -0.1, 0.5, -0.6, -0.9, 1.0],
            )
        ]
        groups = np.array_split(np.arange(n_in, n), 3)
        for g, Td in zip(groups, decoys):
            dst[g] = np.asarray(se3.transform_points(Td, jnp.asarray(src[g])))
        sf, df = _feats_from_identity(n, 0.01, jax.random.PRNGKey(21))

        noise_bound = 0.1
        res = robust_global.register_robust(
            cloud_mod.from_points(jnp.asarray(src)),
            cloud_mod.from_points(jnp.asarray(dst)),
            sf, df, noise_bound,
        )
        assert bool(res.valid)
        assert _twist_err(res.transform, T_true) < 1e-2

        # Show the screens differ: build the same consistency graph and
        # compare the old one-shot degree threshold with the peeled core.
        dp = np.linalg.norm(src[:, None] - src[None, :], axis=-1)
        dq = np.linalg.norm(dst[:, None] - dst[None, :], axis=-1)
        keep = np.ones(n, bool)
        compat = np.abs(dp - dq) <= 2 * noise_bound
        degree = compat.sum(-1) - 1
        old_screen = degree >= 0.5 * degree.mean()  # round-2 formula
        core = np.asarray(
            robust_global.max_kcore(jnp.asarray(compat), jnp.asarray(keep))
        )
        inlier_set = np.zeros(n, bool)
        inlier_set[:n_in] = True
        assert (old_screen & ~inlier_set).sum() > 30  # decoys pass old screen
        np.testing.assert_array_equal(core, inlier_set)  # peeling is exact

    def test_too_few_correspondences_invalid(self):
        src = _scene(jax.random.PRNGKey(8), n=8)
        dst = src
        sf = jnp.asarray(np.random.RandomState(1).rand(8, 33), jnp.float32)
        df = jnp.asarray(np.random.RandomState(2).rand(8, 33), jnp.float32)
        mask = jnp.zeros(8, bool).at[:2].set(True)
        res = robust_global.register_robust(
            cloud_mod.Cloud(src, mask), cloud_mod.Cloud(dst, mask), sf, df, 0.1
        )
        assert not bool(res.valid)


class TestGncIterationBudget:
    def test_64_rounds_converged_at_max_noise_bound(self):
        """TEASER stops on rotation_cost_threshold=1e-6 within <=2048 GNC
        rounds (teaser_interface.cpp:84-91); this repo uses a FIXED 64
        rounds (a fixed-shape loop). Verify sufficiency at the largest
        noise_bound in use (0.25, the register_robust default, annealing
        factor 1.4): doubling the budget to 128 must not move the answer,
        i.e. the mu schedule has saturated well before round 64."""
        src = _scene(jax.random.PRNGKey(30))
        T_true = se3.exp(
            jnp.array([0.3, -0.2, 0.25, 0.6, -0.4, 0.5], jnp.float32)
        )
        dst = np.array(se3.transform_points(T_true, src))
        rng = np.random.RandomState(31)
        dst[:60] += 2.0 * rng.randn(60, 3)  # ~25% outliers
        sf, df = _feats_from_identity(256, 0.01, jax.random.PRNGKey(32))
        kw = dict(noise_bound=0.25)
        res64 = robust_global.register_robust(
            cloud_mod.from_points(src), cloud_mod.from_points(jnp.asarray(dst)),
            sf, df, gnc_iters=64, **kw,
        )
        res128 = robust_global.register_robust(
            cloud_mod.from_points(src), cloud_mod.from_points(jnp.asarray(dst)),
            sf, df, gnc_iters=128, **kw,
        )
        assert bool(res64.valid) and bool(res128.valid)
        assert _twist_err(res64.transform, T_true) < 5e-2
        # Converged: the extra 64 rounds change nothing measurable.
        assert _twist_err(res64.transform, np.asarray(res128.transform)) < 1e-5


class TestAdaptiveGncTermination:
    """TEASER's rotation_cost_threshold early stop (teaser_interface.cpp:
    84-91) replaces the round-3 fixed 64-round scan. Rounds-to-converge
    grow with log(r2_max / cbar2): a tight noise bound under far
    outliers needs MORE than 64 rounds (resolved by making termination
    adaptive)."""

    def _tims(self, seed=7, m=384, scene_scale=30.0, noise=0.003,
              outlier_frac=0.3, outlier_mag=80.0):
        rng = np.random.RandomState(seed)
        R_true = np.asarray(
            se3.exp(jnp.asarray([0, 0, 0, 0.4, -0.3, 0.5], jnp.float32))
        )[:3, :3]
        a = rng.uniform(-scene_scale, scene_scale, (m, 3)).astype(np.float32)
        b = a @ R_true.T + rng.normal(0, noise, (m, 3)).astype(np.float32)
        n_out = int(outlier_frac * m)
        b[:n_out] += rng.uniform(-outlier_mag, outlier_mag,
                                 (n_out, 3)).astype(np.float32)
        return (jnp.asarray(a), jnp.asarray(b),
                jnp.ones((m,), bool), R_true)

    @staticmethod
    def _rot_err(R_est, R_true):
        c = (np.trace(np.asarray(R_est).T @ R_true) - 1.0) / 2.0
        return float(np.arccos(np.clip(c, -1.0, 1.0)))

    def test_small_noise_bound_far_outliers_converges(self):
        # 30 m TIMs, 300 m outliers, 1 mm bound: mu0 ~ cbar2 / (2 r2_max)
        # ~ 6e-12, so reaching binary weights takes
        # ~ log(10/mu0)/log(1.4) > 80 rounds -- a fixed 64-round budget
        # (the old scan, reproduced via max_iters=64 with the early stop
        # disabled) exits ~5e-4 rad short of convergence (measured sweep
        # 2026-08-19).
        a, b, mask, R_true = self._tims(noise=3e-4, outlier_mag=300.0)
        R64, _ = robust_global._gnc_tls_rotation(a, b, mask, 1e-3,
                                                 max_iters=64,
                                                 cost_threshold=0.0)
        Rad, inl = robust_global._gnc_tls_rotation(a, b, mask, 1e-3)
        err64 = self._rot_err(R64, R_true)
        erra = self._rot_err(Rad, R_true)
        assert erra < 1e-4, erra  # adaptive converges fully
        assert err64 > 2e-4, err64  # the fixed budget stops short
        # and the inlier mask recovers the clean 70%
        inl = np.asarray(inl)
        assert inl[int(0.3 * len(inl)):].mean() > 0.9
        assert inl[: int(0.3 * len(inl))].mean() < 0.1

    def test_loose_bound_unchanged(self):
        # The round-3 regime (meter-scale bound): early stop must return
        # the same rotation the fixed 64-round schedule found.
        a, b, mask, R_true = self._tims(scene_scale=2.0, noise=0.02,
                                        outlier_mag=5.0)
        R64, _ = robust_global._gnc_tls_rotation(a, b, mask, 0.5,
                                                 max_iters=64,
                                                 cost_threshold=0.0)
        Rad, _ = robust_global._gnc_tls_rotation(a, b, mask, 0.5)
        np.testing.assert_allclose(np.asarray(Rad), np.asarray(R64),
                                   atol=1e-4)
        assert self._rot_err(Rad, R_true) < 0.02
