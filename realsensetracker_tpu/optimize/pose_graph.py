"""Pose-graph optimization: nonlinear least squares over SE(3) trajectories.

The reference's structure.txt:1-9 lists an `optimize` module ("nonlinear
optimization on graph?") that was never implemented. This is its device-side
realization: given node poses and relative-pose edge measurements (odometry
+ loop closures), minimize

    sum_e || w_e * log( T_meas_e^-1 * T_i^-1 * T_j ) ||^2

by Gauss-Newton with the normal equations solved MATRIX-FREE via conjugate
gradients: Hx products come from jax.jvp/vjp through the residual function,
so no sparse matrix structure is ever materialized -- every CG iteration is
a couple of batched edge evaluations.
Node 0 is gauge-fixed.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from realsensetracker_tpu.geometry import se3


class PoseGraph(NamedTuple):
    poses: jnp.ndarray  # (N, 4, 4) world_from_node estimates
    edges_i: jnp.ndarray  # (E,) int32 source node
    edges_j: jnp.ndarray  # (E,) int32 target node
    measurements: jnp.ndarray  # (E, 4, 4) measured T_i^-1 T_j
    weights: jnp.ndarray  # (E,) scalar edge weights


def from_trajectory(poses, loop_edges=(), odometry=None, odometry_weights=None):
    """Build a graph with consecutive odometry edges + optional loop edges.

    loop_edges: iterable of (i, j, T_ij (4,4), weight).
    odometry: optional explicit consecutive-edge measurements (n-1 of
    (4,4), T_i^-1 T_j as MEASURED at tracking time). Without it the
    measurements are re-extracted from `poses` -- fine for a one-shot
    solve, but WRONG for repeated online optimization: re-extracting from
    already-optimized poses erases the original odometry information a
    little more each round, so streaming callers must pass the
    measurements they recorded at keyframe insertion.
    """
    poses = jnp.asarray(poses, jnp.float32)
    n = poses.shape[0]
    if n < 2:
        raise ValueError(f"a pose graph needs >= 2 poses, got {n}")
    ei = list(range(n - 1))
    ej = list(range(1, n))
    if odometry is None:
        # One batched dispatch, not n-1 eager ones.
        meas = list(se3.compose(se3.inverse(poses[:-1]), poses[1:]))
    else:
        meas = [jnp.asarray(T, jnp.float32) for T in odometry]
        if len(meas) != n - 1:
            raise ValueError(f"odometry must have {n - 1} edges, got {len(meas)}")
    if odometry_weights is None:
        w = [1.0] * (n - 1)
    else:
        # Per-edge odometry confidence: edges spanning tracking loss carry
        # less information (the held pose misses real motion), so the SLAM
        # layer down-weights them and lets loop closures re-anchor.
        w = [float(x) for x in odometry_weights]
        if len(w) != n - 1:
            raise ValueError(
                f"odometry_weights must have {n - 1} entries, got {len(w)}"
            )
    for (i, j, T_ij, weight) in loop_edges:
        if not (0 <= i < n and 0 <= j < n):
            # Fail loudly: a JAX gather would silently CLAMP an
            # out-of-range node index, attaching the constraint to the
            # wrong node and corrupting the optimized trajectory.
            raise ValueError(
                f"loop edge ({i}, {j}) out of range for {n} nodes"
            )
        ei.append(i)
        ej.append(j)
        meas.append(jnp.asarray(T_ij, jnp.float32))
        w.append(float(weight))
    return PoseGraph(
        poses=poses,
        edges_i=jnp.asarray(ei, jnp.int32),
        edges_j=jnp.asarray(ej, jnp.int32),
        measurements=jnp.stack(meas),
        weights=jnp.asarray(w, jnp.float32),
    )


def _edge_residuals(twists, graph: PoseGraph):
    """Stacked weighted residuals (E, 6) at correction `twists` (N, 6).

    Node poses are T_n = exp(twist_n) @ pose_n; node 0's twist is zeroed
    (gauge fix).
    """
    twists = twists.at[0].set(0.0)
    T = se3.compose(se3.exp(twists), graph.poses)  # (N, 4, 4)
    Ti = T[graph.edges_i]
    Tj = T[graph.edges_j]
    pred = se3.compose(se3.inverse(Ti), Tj)
    err = se3.compose(se3.inverse(graph.measurements), pred)
    return se3.log(err) * graph.weights[:, None]


def _cg(matvec, b, iters: int, eps: float = 1e-12, precond=None):
    """(Preconditioned) conjugate gradients for SPD systems, fixed count.

    precond: optional M^-1 apply. Without it this is plain CG (z = r).
    The preconditioner output is guarded: if an apply goes non-finite
    (e.g. a numerically singular backbone block on reduced-precision
    hardware), that apply degrades to the identity preconditioner instead
    of poisoning the whole solve."""
    if precond is None:
        precond = lambda r: r  # noqa: E731

    def safe_precond(r):
        z = precond(r)
        return jnp.where(jnp.all(jnp.isfinite(z)), z, r)

    def body(_, state):
        x, r, z, p, rz = state
        Ap = matvec(p)
        alpha = rz / jnp.maximum(jnp.vdot(p, Ap), eps)
        x = x + alpha * p
        r = r - alpha * Ap
        z = safe_precond(r)
        rz_new = jnp.vdot(r, z)
        beta = rz_new / jnp.maximum(rz, eps)
        p = z + beta * p
        return x, r, z, p, rz_new

    x0 = jnp.zeros_like(b)
    z0 = safe_precond(b)
    state = (x0, b, z0, z0, jnp.vdot(b, z0))
    x, *_ = jax.lax.fori_loop(0, iters, body, state)
    return x


def _inv6(M):
    """Scale-normalized 6x6 inverse: inv(M) = inv(M/s)/s with s = tr(M)/6.

    Keeps the LU factorization's pivots near unit scale regardless of the
    edge-weight magnitudes feeding the blocks -- poorly scaled blocks are
    where a float32 factorization goes singular first."""
    s = jnp.trace(M) / 6.0
    s = jnp.where(jnp.abs(s) > 1e-30, s, 1.0)
    return jnp.linalg.inv(M / s) / s


def _block_tridiag_precond(graph: PoseGraph, poses, w_rob, n, damping):
    """Block-tridiagonal (odometry-backbone) preconditioner for CG.

    Exact per-edge 6x12 Jacobians w.r.t. the two endpoint twists come from
    one vmapped jacfwd over (12,) locals. ALL edges contribute their
    J_i^T J_i / J_j^T J_j to the per-node 6x6 diagonal blocks; CHAIN edges
    (j == i+1, the odometry backbone) additionally contribute their
    J_i^T J_j coupling block, and the resulting block-tridiagonal matrix M
    is factorized exactly (block LDL^T, one lax.scan of 6x6 ops) so each
    preconditioner apply solves the whole backbone in closed form.

    Why not plain block-Jacobi: a diagonal preconditioner is LOCAL, so PCG
    still moves information only one node per iteration along the chain --
    measured on a 1000-node 5%-loop graph, block-Jacobi at 60 iterations
    stalled at 1.47x the converged cost (plain CG needed ~1500 iterations).
    The backbone factorization propagates corrections globally in ONE
    apply; CG only has to fix up the (low-rank) loop-edge couplings, and
    the same graph converges within 1.05x of the exhaustive reference at
    the standard 60-iteration budget."""
    w_total = graph.weights * w_rob
    eye6 = jnp.eye(6, dtype=jnp.float32)
    if n < 2:
        return lambda r: r

    def edge_r(tw12, pose_i, pose_j, meas, w):
        Ti = se3.compose(se3.exp(tw12[:6]), pose_i)
        Tj = se3.compose(se3.exp(tw12[6:]), pose_j)
        pred = se3.compose(se3.inverse(Ti), Tj)
        err = se3.compose(se3.inverse(meas), pred)
        return se3.log(err) * w

    Je = jax.vmap(jax.jacfwd(edge_r))(
        jnp.zeros((graph.edges_i.shape[0], 12), jnp.float32),
        poses[graph.edges_i],
        poses[graph.edges_j],
        graph.measurements,
        w_total,
    )  # (E, 6, 12)
    Ji, Jj = Je[:, :, :6], Je[:, :, 6:]
    hi = jax.lax.Precision.HIGHEST
    Bi = jnp.einsum("eri,erj->eij", Ji, Ji, precision=hi)
    Bj = jnp.einsum("eri,erj->eij", Jj, Jj, precision=hi)
    D = (
        jnp.zeros((n, 6, 6), jnp.float32)
        .at[graph.edges_i].add(Bi)
        .at[graph.edges_j].add(Bj)
    ) + (damping + 1e-8) * eye6
    # Node 0 is gauge-fixed (its twist coords stay 0): identity block with
    # no couplings, matching the matvec's zeroed row/column.
    D = D.at[0].set(eye6)

    # Superdiagonal blocks M[i, i+1] = sum over chain edges of J_i^T J_j,
    # indexed by the lower node i (shape (n-1, 6, 6)). Loop edges are left
    # to CG. O_0 = 0 keeps the gauge block decoupled.
    is_chain = (graph.edges_j == graph.edges_i + 1) & (graph.edges_i > 0)
    Bij = jnp.einsum("eri,erj->eij", Ji, Jj, precision=hi)
    O = jnp.zeros((n - 1, 6, 6), jnp.float32).at[graph.edges_i].add(
        jnp.where(is_chain[:, None, None], Bij, 0.0)
    )

    # Block LDL^T of the tridiagonal: S_0 = D_0; S_i = D_i - O_{i-1}^T
    # S_{i-1}^{-1} O_{i-1}; store S_i^{-1} and U_{i-1} = S_{i-1}^{-1} O_{i-1}.
    # All matmuls at HIGHEST precision: the factorization feeds back into
    # itself along the whole chain, and reduced-precision operand rounding
    # (bf16, TF32) would compound across hundreds of nodes.
    S0_inv = _inv6(D[0])

    def factor_step(S_prev_inv, DO):
        D_i, O_im1 = DO
        U = jnp.matmul(S_prev_inv, O_im1, precision=hi)
        S = D_i - jnp.matmul(O_im1.T, U, precision=hi) + 1e-10 * eye6
        S_inv = _inv6(S)
        return S_inv, (S_inv, U)

    _, (S_inv_rest, U) = jax.lax.scan(factor_step, S0_inv, (D[1:], O))
    S_inv = jnp.concatenate([S0_inv[None], S_inv_rest], axis=0)  # (n, 6, 6)

    def precond(r):
        rn = r.reshape(n, 6).astype(jnp.float32)

        # L y = r  (L unit lower block-bidiagonal, L[i, i-1] = U_{i-1}^T).
        def fwd(y_prev, rU):
            r_i, U_im1 = rU
            y_i = r_i - jnp.matmul(U_im1.T, y_prev, precision=hi)
            return y_i, y_i

        y0 = rn[0]
        _, y_rest = jax.lax.scan(fwd, y0, (rn[1:], U))
        y = jnp.concatenate([y0[None], y_rest], axis=0)

        # S u = y (batched), then L^T z = u (backward: z_i = u_i - U_i z_{i+1}).
        u = jnp.einsum("nij,nj->ni", S_inv, y, precision=hi)

        def bwd(z_next, uU):
            u_i, U_i = uU
            z_i = u_i - jnp.matmul(U_i, z_next, precision=hi)
            return z_i, z_i

        z_last = u[-1]
        _, z_rest = jax.lax.scan(bwd, z_last, (u[:-1], U), reverse=True)
        z = jnp.concatenate([z_rest, z_last[None]], axis=0)
        return z.reshape(-1).astype(r.dtype)

    return precond


@partial(jax.jit, static_argnames=("gn_iters", "cg_iters", "huber_delta", "precondition"))
def optimize_pose_graph(
    graph: PoseGraph,
    gn_iters: int = 10,
    cg_iters: int = 50,
    damping: float = 1e-6,
    huber_delta: float = 0.1,
    precondition: bool = True,
    trust_radius: float = 2.0,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Optimize node poses; returns (poses (N, 4, 4), final cost).

    Each iteration linearizes all edges at once and solves the damped
    normal equations with matrix-free CG (Hv = J^T(J v) via jvp+vjp),
    preconditioned by default with an exact block-LDL^T factorization of
    the odometry backbone (see _block_tridiag_precond) so the fixed
    cg_iters budget converges on 1000-node graphs, not just ~40-node ones.

    The step is SAFEGUARDED (Levenberg-Marquardt accept/reject, the same
    scheme Ceres applies to the reference's GICP solve,
    align_gicp.cpp:19-21 TRUST_REGION/LM): each candidate step is clipped
    to `trust_radius` per-node twist norm, evaluated against the current
    robustified cost, and REJECTED (poses kept, damping x10) if it fails
    to decrease it or goes non-finite; accepted steps relax damping /2.
    An unsafeguarded GN loop diverges to NaN on large drifted graphs whose
    loop residuals approach the pi rotation branch cut -- measured on a
    real 229-keyframe, 48-loop, meter-scale-drift graph.

    huber_delta: robust kernel scale on each edge's twist-norm residual
    (IRLS, re-evaluated per GN iteration). Staged GNC-style schedule: the
    first half of the iterations uses the CONVEX Huber weight (pulls
    large-but-true loop residuals in without rejecting them), the second
    half switches to the REDESCENDING Geman-McClure weight (the
    reference's own GNC form, align_icp.cpp:116-118), which drives a
    persistently-inconsistent edge's weight to ~0 instead of merely
    capping its influence -- Huber alone still lets one grossly-wrong
    loop edge bias every pose. 0 disables.
    """
    n = graph.poses.shape[0]

    def gn_step(it, carry):
        poses, lm_damping, _cost = carry
        g = graph._replace(poses=poses)
        zero = jnp.zeros((n, 6), jnp.float32)

        # IRLS robust weights from the CURRENT residuals, fixed for this
        # linearization.
        r_edges = _edge_residuals(zero, g)  # (E, 6), already edge-weighted
        if huber_delta > 0:
            rn = jnp.linalg.norm(r_edges, axis=-1)
            d2 = jnp.float32(huber_delta * huber_delta)
            w_huber = jnp.minimum(1.0, huber_delta / jnp.maximum(rn, 1e-12))
            w_gm = (d2 / (rn * rn + d2)) ** 2
            use_gm = it >= gn_iters // 2
            w_rob = jnp.sqrt(jnp.where(use_gm, w_gm, w_huber))
        else:
            w_rob = jnp.ones(r_edges.shape[0], jnp.float32)

        def res_flat(tw):
            return (
                _edge_residuals(tw.reshape(n, 6), g) * w_rob[:, None]
            ).reshape(-1)

        r0 = res_flat(zero.reshape(-1))
        _, vjp = jax.vjp(res_flat, zero.reshape(-1))

        def matvec(v):
            _, jv = jax.jvp(res_flat, (zero.reshape(-1),), (v,))
            (jtjv,) = vjp(jv)
            return jtjv + lm_damping * v

        (grad,) = vjp(r0)
        precond = (
            _block_tridiag_precond(graph, poses, w_rob, n, lm_damping)
            if precondition
            else None
        )
        dx = _cg(matvec, -grad, cg_iters, precond=precond)
        dx = jnp.where(jnp.isfinite(dx), dx, 0.0)
        tw = dx.reshape(n, 6).at[0].set(0.0)
        # Trust region: clip each node's step. A single ill-conditioned
        # linearization (log Jacobian ~ 1/sin(theta) near pi) can emit a
        # huge but useless step; beyond ~pi per iteration it carries no
        # information anyway.
        step_norm = jnp.linalg.norm(tw, axis=-1, keepdims=True)
        tw = tw * jnp.minimum(1.0, trust_radius / jnp.maximum(step_norm, 1e-12))
        new_poses = se3.compose(se3.exp(tw), poses)
        cost = 0.5 * jnp.sum(r0 * r0)

        # LM accept/reject under the SAME robust weights.
        r_new = (
            _edge_residuals(zero, g._replace(poses=new_poses)) * w_rob[:, None]
        )
        new_cost = 0.5 * jnp.sum(r_new * r_new)
        accept = jnp.isfinite(new_cost) & jnp.all(
            jnp.isfinite(new_poses)
        ) & (new_cost <= cost)
        poses = jnp.where(accept, new_poses, poses)
        lm_damping = jnp.where(
            accept,
            jnp.maximum(lm_damping * 0.5, damping),
            jnp.minimum(lm_damping * 10.0, 1e4),
        )
        return poses, lm_damping, cost

    poses, _lm, cost = jax.lax.fori_loop(
        0, gn_iters, gn_step, (graph.poses, jnp.float32(damping), jnp.float32(0.0))
    )
    # Report the cost at the final poses.
    final_r = _edge_residuals(jnp.zeros((n, 6), jnp.float32), graph._replace(poses=poses))
    return poses, 0.5 * jnp.sum(final_r * final_r)
