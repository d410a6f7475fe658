"""Weighted Kabsch rigid alignment (SVD).

Reproduces the exact semantics of the reference's SolveKabsch
(align_icp.cpp:18-71), including its quirks, so parity tests can hit 1e-4:

* centroids are UNWEIGHTED means over the matched pairs even when weights
  are provided (align_icp.cpp:28-35);
* the cross-covariance is accumulated in float64 (align_icp.cpp:37);
* the reflection fix flips the third column of the composed R = U V^T
  (align_icp.cpp:61-63), not of U;
* t = dst_mean - R @ src_mean (align_icp.cpp:66).

Without x64 the accumulation dtype canonicalizes to f32; CPU parity
tests enable jax_enable_x64 to match the C++ double accumulation.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from realsensetracker_tpu.geometry import se3


def _acc_dtype():
    return jax.dtypes.canonicalize_dtype(jnp.float64)


def kabsch_from_cross_covariance(
    cov: jnp.ndarray, src_mean: jnp.ndarray, dst_mean: jnp.ndarray
) -> jnp.ndarray:
    """Rotation from a 3x3 cross-covariance (dst-centered x src-centered^T),
    with the reference's det fix (align_icp.cpp:58-66), then translation."""
    u, _, vt = jnp.linalg.svd(cov)
    R = (u @ vt).astype(jnp.float32)
    det = jnp.linalg.det(R)
    R = R.at[..., :, 2].multiply(jnp.where(det < 0, -1.0, 1.0)[..., None])
    t = dst_mean - jnp.squeeze(R @ src_mean[..., :, None], -1)
    return se3.from_rt(R, t)


def solve_kabsch(
    src_points: jnp.ndarray,
    dst_points: jnp.ndarray,
    weights: jnp.ndarray | None = None,
    mask: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """Rigid transform aligning matched src->dst point pairs (N, 3).

    `mask` marks valid pairs (fixed-capacity masking replaces the reference's
    variable-length index list). `weights` scale only the covariance terms,
    matching SolveKabsch (align_icp.cpp:46-56).
    """
    acc = _acc_dtype()
    if mask is None:
        mask = jnp.ones(src_points.shape[:-1], dtype=bool)
    m = mask.astype(acc)
    n = jnp.maximum(jnp.sum(m, axis=-1), 1.0)
    src64 = src_points.astype(acc)
    dst64 = dst_points.astype(acc)
    src_mean = jnp.sum(src64 * m[..., None], axis=-2) / n[..., None]
    dst_mean = jnp.sum(dst64 * m[..., None], axis=-2) / n[..., None]
    w = m if weights is None else m * weights.astype(acc)
    ds = (src64 - src_mean[..., None, :]) * w[..., None]
    dd = dst64 - dst_mean[..., None, :]
    cov = jnp.einsum("...ni,...nj->...ij", dd, ds, precision=jax.lax.Precision.HIGHEST)
    return kabsch_from_cross_covariance(
        cov, src_mean.astype(jnp.float32), dst_mean.astype(jnp.float32)
    )
