"""Robust global registration: GNC-TLS rotation + component-wise translation.

Dense-tensor replacement for the reference's TEASER++ bridge
(teaser_interface.cpp:20-133). The reference configures TEASER++ with:
GNC_TLS rotation (2048 iters, gnc_factor 1.4, cost threshold 1e-6),
cbar2 = 1, no scale estimation, and the k-core heuristic (threshold 0.5)
instead of exact max-clique (teaser_interface.cpp:79-99). Correspondences
come from mutual (cross-checked) FPFH matching (:66-68) and >=3 are required
(:71-73).

This formulation keeps that estimation pipeline but swaps graph
algorithms for dense tensor ops:

1. mutual 1-NN feature matching (two dense kNN passes);
2. pairwise translation-invariant consistency graph: pairs (i, j) are
   compatible when ||p_i-p_j| - |q_i-q_j|| <= 2*noise_bound; inlier
   selection extracts the MAXIMUM k-core of this graph by true iterative
   peeling (binary search over k, simultaneous-removal peeling to a fixed
   point at each probe) -- the standard surrogate for TEASER's PMC_EXACT
   max clique, since any clique of size c lives inside the (c-1)-core;
3. GNC-TLS rotation over translation-invariant measurements (TIMs) built
   from a random pair basis, solved by iterating weighted-SVD Kabsch
   (rotation-only) with the standard GNC-TLS mu schedule;
4. component-wise translation by consensus voting + inlier mean.
"""

from __future__ import annotations

import math
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from realsensetracker_tpu.geometry import se3
from realsensetracker_tpu.ops import correspond
from realsensetracker_tpu.ops.cloud import Cloud


class RobustRegistrationResult(NamedTuple):
    transform: jnp.ndarray  # (4, 4)
    valid: jnp.ndarray  # bool: enough consistent correspondences
    num_correspondences: jnp.ndarray
    num_inliers: jnp.ndarray
    rotation_inlier_fraction: jnp.ndarray


def mutual_matches(
    src_feats: jnp.ndarray,
    dst_feats: jnp.ndarray,
    src_mask: jnp.ndarray,
    dst_mask: jnp.ndarray,
):
    """Cross-checked 1-NN feature correspondences (Matcher cross_check=true,
    teaser_interface.cpp:66-68). Returns (dst_index (N,), keep (N,))."""
    fwd_idx, _ = correspond.nearest_neighbors(src_feats, Cloud(dst_feats, dst_mask))
    bwd_idx, _ = correspond.nearest_neighbors(dst_feats, Cloud(src_feats, src_mask))
    n = src_feats.shape[0]
    keep = (bwd_idx[fwd_idx] == jnp.arange(n)) & src_mask
    return fwd_idx, keep


def max_kcore(adj: jnp.ndarray, keep: jnp.ndarray) -> jnp.ndarray:
    """Membership mask of the maximum (non-empty) k-core of `adj`.

    The reference configures TEASER++ with PMC_EXACT max-clique inlier
    selection behind a k-core pre-screen at threshold 0.5
    (teaser_interface.cpp:92-99). A clique of size c is contained in the
    (c-1)-core, so the maximum k-core is the standard dense surrogate for
    the max clique (TEASER's own KCORE_HEU fallback). Dense shape: binary
    search over k; each probe peels to a fixed point by SIMULTANEOUS
    removal of all vertices of degree < k -- every peeling round is one
    masked boolean row-reduction of the dense adjacency, no sorting, no
    dynamic shapes.

    adj: (N, N) bool symmetric adjacency (self-loops ignored).
    keep: (N,) bool candidate mask. Returns (N,) bool core membership
    (all-False iff keep is all-False).
    """
    n = keep.shape[0]
    adj = adj & ~jnp.eye(n, dtype=bool) & keep[:, None] & keep[None, :]

    def core_at(k):
        """Peel vertices of degree < k until nothing changes."""

        def cond(state):
            _, changed, it = state
            return changed & (it < n)

        def body(state):
            alive, _, it = state
            deg = jnp.sum(adj & alive[None, :], axis=-1)
            new = alive & (deg >= k)
            return new, jnp.any(new != alive), it + 1

        alive, _, _ = jax.lax.while_loop(
            cond, body, (keep, jnp.bool_(True), jnp.int32(0))
        )
        return alive

    # Binary search the largest k with a non-empty k-core. core_at(0) ==
    # keep (feasible); degree < n bounds k above. lo stays feasible.
    steps = max(1, math.ceil(math.log2(n + 1)) + 1)

    def search(_, state):
        lo, hi, best = state
        mid = (lo + hi + 1) // 2
        core = core_at(mid)
        nonempty = jnp.any(core)
        lo = jnp.where(nonempty, mid, lo)
        hi = jnp.where(nonempty, hi, mid - 1)
        best = jnp.where(nonempty, core, best)
        return lo, hi, best

    _, _, best = jax.lax.fori_loop(
        0, steps, search, (jnp.int32(0), jnp.int32(n), keep)
    )
    return best


def _gnc_tls_rotation(
    a: jnp.ndarray,  # (M, 3) source TIMs
    b: jnp.ndarray,  # (M, 3) destination TIMs
    mask: jnp.ndarray,  # (M,)
    noise_bound: float,
    max_iters: int = 2048,
    gnc_factor: float = 1.4,
    cost_threshold: float = 1e-6,
):
    """GNC-TLS rotation search (teaser params, teaser_interface.cpp:83-91).

    Iterates: weighted rotation-only Kabsch -> TLS residuals -> GNC weight
    update with mu *= gnc_factor, until the weighted cost stops changing
    (TEASER's rotation_cost_threshold exit, teaser_interface.cpp:84-91 --
    made RELATIVE here: |cost - prev| < cost_threshold * prev, since the
    absolute form is unit/TIM-count sensitive) or max_iters. Adaptive
    termination matters for correctness, not just reference shape:
    rounds-to-converge grow with log(r2_max / cbar2) / log(gnc_factor),
    so a tight noise_bound under far outliers (measured: 1 mm bound with
    300 m outliers) leaves the old fixed 64-round scan ~5e-4 rad short
    of convergence while a loose bound never needs 30 rounds
    (tests/test_robust_global.py::TestAdaptiveGncTermination).
    Returns (R, inlier mask).
    """
    m = mask.astype(jnp.float32)
    cbar2 = noise_bound * noise_bound  # cbar2 multiplier = 1 (:81)

    def solve_rotation(w):
        cov = jnp.einsum("m,mi,mj->ij", w, b, a, precision=jax.lax.Precision.HIGHEST)
        u, _, vt = jnp.linalg.svd(cov)
        R = u @ vt
        det = jnp.linalg.det(R)
        return R.at[:, 2].multiply(jnp.where(det < 0, -1.0, 1.0))

    # Initialize mu from the max residual (standard GNC-TLS schedule).
    R0 = solve_rotation(m)
    r2_0 = jnp.sum((b - jnp.matmul(a, R0.T, precision=jax.lax.Precision.HIGHEST)) ** 2, axis=-1) * m
    r2_max = jnp.maximum(jnp.max(r2_0), cbar2 * (1.0 + 1e-6))
    mu0 = 1.0 / (2.0 * r2_max / cbar2 - 1.0)

    f32, i32 = jnp.float32, jnp.int32

    def cond(carry):
        _R, _mu, _cost, i, done = carry
        return (~done) & (i < i32(max_iters))

    def body(carry):
        R, mu, prev_cost, i, _done = carry
        r2 = jnp.sum((b - jnp.matmul(a, R.T, precision=jax.lax.Precision.HIGHEST)) ** 2, axis=-1)
        lo = mu / (mu + 1.0) * cbar2
        hi = (mu + 1.0) / mu * cbar2
        w_mid = jnp.sqrt(cbar2 * mu * (mu + 1.0) / jnp.maximum(r2, 1e-30)) - mu
        w = jnp.where(r2 <= lo, 1.0, jnp.where(r2 >= hi, 0.0, jnp.clip(w_mid, 0.0, 1.0)))
        w = w * m
        R_new = solve_rotation(w)
        cost = jnp.sum(w * r2).astype(f32)
        done = jnp.abs(cost - prev_cost) <= f32(cost_threshold) * prev_cost
        # A non-finite cost (NaN input surviving into the TIMs) can never
        # satisfy the stability test, and under vmap (the one-dispatch
        # batched loop-closure/atlas verify) ONE such lane would drag
        # every lane through all max_iters rounds -- bail out instead.
        done = done | ~jnp.isfinite(cost)
        return (R_new, mu * gnc_factor, cost, i + i32(1), done)

    # prev_cost starts NEGATIVE: |cost - prev| <= thr * prev is then false
    # on the first iteration (an inf sentinel would satisfy inf <= inf and
    # stop the loop immediately).
    R, _, _, _, _ = jax.lax.while_loop(
        cond, body,
        (R0, mu0.astype(f32), f32(-1.0), i32(0), jnp.bool_(False)),
    )
    r2 = jnp.sum((b - jnp.matmul(a, R.T, precision=jax.lax.Precision.HIGHEST)) ** 2, axis=-1)
    inlier = (r2 <= cbar2) & mask
    return R, inlier


def _consensus_translation(t_cand: jnp.ndarray, mask: jnp.ndarray, beta: float):
    """Component-wise translation voting: per axis, pick the candidate whose
    +-beta window contains the most votes, then average that window
    (TEASER's adaptive voting, dense formulation)."""
    def per_axis(x):
        diff = jnp.abs(x[:, None] - x[None, :])  # (M, M)
        votes = (diff <= beta) & mask[None, :] & mask[:, None]
        counts = jnp.sum(votes, axis=-1)
        best = jnp.argmax(counts)
        sel = votes[best]
        w = sel.astype(x.dtype)
        return jnp.sum(x * w) / jnp.maximum(jnp.sum(w), 1.0)

    return jax.vmap(per_axis, in_axes=1)(t_cand)


@jax.jit
def symmetric_overlap(
    T: jnp.ndarray, src: Cloud, dst: Cloud, tau: jnp.ndarray | float
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Fraction of each cloud within `tau` of the other under T (src->dst).

    The decisive acceptance check for a claimed registration: a correct
    transform makes the overlapping surfaces coincide in BOTH directions,
    while a confidently wrong GNC fit only aligns its own inlier subset
    (measured: wrong loop registrations on sphere scenes score <= 0.34,
    correct ones 1.0 at tau = voxel size). Two dense NN passes.
    """
    R, t = T[:3, :3], T[:3, 3]
    tau2 = jnp.asarray(tau) ** 2
    p_fwd = jnp.matmul(src.points, R.T, precision=jax.lax.Precision.HIGHEST) + t
    _, d2f = correspond.nearest_neighbors(p_fwd, dst)
    fwd = jnp.sum((d2f < tau2) & src.mask) / jnp.maximum(jnp.sum(src.mask), 1)
    Rin = R.T
    tin = -jnp.matmul(R.T, t, precision=jax.lax.Precision.HIGHEST)
    p_bwd = jnp.matmul(dst.points, Rin.T, precision=jax.lax.Precision.HIGHEST) + tin
    _, d2b = correspond.nearest_neighbors(p_bwd, src)
    bwd = jnp.sum((d2b < tau2) & dst.mask) / jnp.maximum(jnp.sum(dst.mask), 1)
    return fwd, bwd


@partial(jax.jit, static_argnames=("max_tims", "gnc_iters"))
def register_robust(
    src: Cloud,
    dst: Cloud,
    src_feats: jnp.ndarray,
    dst_feats: jnp.ndarray,
    noise_bound: float = 0.25,
    max_tims: int = 1024,
    gnc_iters: int = 2048,  # BOUND, not a trip count: the GNC loop exits
    # at TEASER's rotation_cost_threshold (teaser_interface.cpp:84-91),
    # typically ~40-90 rounds; see _gnc_tls_rotation on why a fixed small
    # budget breaks at small noise bounds
) -> RobustRegistrationResult:
    """Full robust global registration (ref RegisterTeaser,
    teaser_interface.cpp:20-133): FPFH mutual matching -> max-k-core inlier
    screening -> GNC-TLS rotation on TIMs -> consensus translation."""
    n = src.capacity
    match_idx, keep = mutual_matches(src_feats, dst_feats, src.mask, dst.mask)
    p = src.points
    q = dst.points[match_idx]

    # Dense pairwise consistency graph; inlier screen = maximum k-core by
    # iterative peeling (the PMC_EXACT clique surrogate,
    # teaser_interface.cpp:92-99). True-inlier matches are mutually
    # consistent (they form a clique); structured outlier groups form
    # SMALLER cliques, so the max core isolates the dominant consistent set
    # where a one-shot degree threshold admits every sizable group.
    dp = jnp.linalg.norm(p[:, None, :] - p[None, :, :], axis=-1)
    dq = jnp.linalg.norm(q[:, None, :] - q[None, :, :], axis=-1)
    compat = (jnp.abs(dp - dq) <= 2.0 * noise_bound) & keep[:, None] & keep[None, :]
    screened = max_kcore(compat, keep)

    # TIMs from a shifted-pair basis (chain + strides) bounded by max_tims.
    m = min(max_tims, n)
    shifts = (1, 2, 5, 11)
    idx_i = jnp.concatenate([jnp.arange(m) for _ in shifts])
    idx_j = jnp.concatenate([(jnp.arange(m) + s) % n for s in shifts])
    a = p[idx_i] - p[idx_j]
    b = q[idx_i] - q[idx_j]
    tim_mask = screened[idx_i] & screened[idx_j]

    R, rot_inliers = _gnc_tls_rotation(
        a, b, tim_mask, 2.0 * noise_bound, max_iters=gnc_iters
    )

    t_cand = q - jnp.matmul(p, R.T, precision=jax.lax.Precision.HIGHEST)  # (N, 3) translation votes
    t = _consensus_translation(t_cand, screened, noise_bound)

    resid = jnp.linalg.norm(q - (p @ R.T + t), axis=-1)
    inliers = screened & (resid <= noise_bound)
    T = se3.from_rt(R.astype(jnp.float32), t.astype(jnp.float32))
    n_corr = jnp.sum(keep)
    return RobustRegistrationResult(
        transform=T,
        valid=n_corr > 3,  # teaser_interface.cpp:71-73
        num_correspondences=n_corr,
        num_inliers=jnp.sum(inliers),
        rotation_inlier_fraction=jnp.sum(rot_inliers)
        / jnp.maximum(jnp.sum(tim_mask), 1),
    )
