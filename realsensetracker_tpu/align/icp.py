"""GNC-weighted point-to-point ICP, reference-exact semantics.

JAX port of AlignIcp3d (align_icp.cpp:73-167). The per-iteration
KD-tree 1-NN (align_icp.cpp:112) becomes a dense brute-force search as a
matrix product (ops/correspond.py); everything else follows the reference precisely:

* src_mean is computed ONCE from the untransformed source (align_icp.cpp:85);
* Geman-McClure/GNC weight l = (mu / (d^2 + mu))^2 with mu annealed by
  mu /= 1.4 every 8 iterations, skipping iteration 0 (align_icp.cpp:96-118);
* dst_mean is the unweighted mean of matched destination points (:101-122);
* the weighted cross-covariance uses ORIGINAL (untransformed) src coords, so
  each iteration re-solves the absolute transform (:126-136);
* SVD + det column fix + t = dst_mean - R src_mean (:139-151);
* success test: sqrt(cost / n) < 10000, i.e. effectively always true (:157-160).

Covariance accumulates in f64 when x64 is enabled (CPU parity tests),
matching the C++ `Eigen::Matrix3d cov` (align_icp.cpp:125); canonicalizes to
f32 otherwise (the production setting).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from realsensetracker_tpu.align.kabsch import kabsch_from_cross_covariance, _acc_dtype
from realsensetracker_tpu.geometry import se3
from realsensetracker_tpu.ops import correspond
from realsensetracker_tpu.ops.cloud import Cloud


class IcpResult(NamedTuple):
    transform: jnp.ndarray  # (4, 4) absolute src->dst transform
    mean_cost: jnp.ndarray  # sqrt(sum d^2 / n), as align_icp.cpp:157
    success: jnp.ndarray  # bool, align_icp.cpp:160 semantics
    num_valid: jnp.ndarray


@partial(jax.jit, static_argnames=("max_iter", "chunk"))
def align_icp(
    src: Cloud,
    dst: Cloud,
    max_iter: int = 128,
    init_transform: jnp.ndarray | None = None,
    chunk: int = 2048,
) -> IcpResult:
    """Align src onto dst; returns the absolute transform like AlignIcp3d.

    The iteration count is a static constant (the reference uses 128,
    rs_replay_app.cpp:251) so the whole solve compiles to one XLA loop.
    """
    acc = _acc_dtype()
    if init_transform is None:
        init_transform = se3.identity()

    src_m = src.mask.astype(jnp.float32)
    n_src = jnp.maximum(jnp.sum(src_m), 1.0)
    # src_mean over valid source points, computed once (align_icp.cpp:85-86).
    src_mean64 = (
        jnp.sum(src.points.astype(acc) * src_m[:, None].astype(acc), axis=0)
        / n_src.astype(acc)
    )
    src_mean = src_mean64.astype(jnp.float32)

    def body(it, carry):
        xfm, _cost, mu = carry
        # GNC anneal (align_icp.cpp:96-98).
        mu = jnp.where((it > 0) & (it % 8 == 0), mu / 1.4, mu)

        p = se3.transform_points(xfm, src.points)
        nbr_idx, _ = correspond.nearest_neighbors(p, dst, chunk=chunk)
        # Recompute the matched distance directly: the |a|^2+|b|^2-2ab matmul
        # form used for the search loses ~1e-7 absolute precision, which
        # matters for the GNC weights/cost once d^2 -> 0 near convergence.
        diff = p - dst.points[nbr_idx]
        d2 = jnp.sum(diff * diff, axis=-1)
        d2 = jnp.where(src.mask, d2, 0.0)
        cost = jnp.sum(d2)

        l_rt = mu / (d2 + mu)
        w = l_rt * l_rt * src_m  # (align_icp.cpp:116-118), masked

        matched = dst.points[nbr_idx]
        # Unweighted mean of matched dst points (align_icp.cpp:101-122).
        dst_mean64 = (
            jnp.sum(matched.astype(acc) * src_m[:, None].astype(acc), axis=0)
            / n_src.astype(acc)
        )
        dst_mean = dst_mean64.astype(jnp.float32)

        # Weighted covariance with ORIGINAL src coords (align_icp.cpp:126-136).
        dd = matched.astype(acc) - dst_mean64
        ds = (src.points.astype(acc) - src_mean64) * w[:, None].astype(acc)
        cov = jnp.matmul(dd.T, ds, precision=jax.lax.Precision.HIGHEST)

        new_xfm = kabsch_from_cross_covariance(cov, src_mean, dst_mean)
        return new_xfm, cost, mu

    xfm, cost, _ = jax.lax.fori_loop(
        0, max_iter, body, (init_transform, jnp.float32(0.0), jnp.float32(1.0))
    )
    mean_cost = jnp.sqrt(cost / n_src)
    enough = (jnp.sum(src.mask) >= 3) & (jnp.sum(dst.mask) >= 3)
    return IcpResult(
        transform=jnp.where(enough, xfm, init_transform),
        mean_cost=mean_cost,
        success=enough & (mean_cost < 10000.0),
        num_valid=jnp.sum(src.mask),
    )
