"""Photometric (direct) alignment: intensity residuals over projected points.

The reference sketches this and never finishes it: photometric_cost.hpp
(references undefined GetColor/project, compiles nowhere) plus the jet
sampling machinery (sample.hpp/jet_extras.hpp). Here it is a WORKING module:

    r_i(xi) = I_dst( project(exp(xi) T p_i) ) - I_src(p_i's pixel)

with bilinear sampling (ops/sampling.py) and the (P, 6) Jacobian obtained by
jax.jacfwd through the projection AND the bilinear interpolation -- the
autodiff the reference hand-rolled with ceres::Jet chain rules. Solved by
damped Gauss-Newton with Huber weights; optionally combined with the
geometric point-to-plane term for RGB-D odometry.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from realsensetracker_tpu.geometry import camera, se3
from realsensetracker_tpu.ops.sampling import bilinear_sample


class PhotometricConfig(NamedTuple):
    iters: int = 10
    samples: int = 2048
    huber_delta: float = 0.1  # intensity units
    damping: float = 1e-5
    min_depth: float = 0.05


class PhotometricResult(NamedTuple):
    transform: jnp.ndarray
    rmse: jnp.ndarray
    num_valid: jnp.ndarray


def photometric_residuals(T, src_pts, src_intensity, dst_image, intr,
                          min_depth: float = 0.05):
    """Residuals r (P,) + validity for points with attached intensities.

    min_depth gates projections whose transformed depth falls below the
    near plane (PhotometricConfig.min_depth feeds through here -- a
    hardcoded epsilon would let near-degenerate, huge-Jacobian points in
    no matter what the config says).
    """
    p = se3.transform_points(T, src_pts)
    u, v, z = camera.project(p, intr)
    vals, inb = bilinear_sample(dst_image, u, v)
    ok = inb & (z > min_depth)
    return jnp.where(ok, vals - src_intensity, 0.0), ok


def huber_weight(r, delta):
    """IRLS weight of the Huber loss on a plain residual (shared by the
    standalone photometric aligner and the joint RGB-D term)."""
    a = jnp.abs(r)
    return jnp.where(a <= delta, 1.0, delta / jnp.maximum(a, 1e-30))


_huber_w = huber_weight  # back-compat alias


@partial(jax.jit, static_argnames=("intr", "cfg"))
def align_photometric(
    src_pts: jnp.ndarray,  # (P, 3) source points (camera frame)
    src_intensity: jnp.ndarray,  # (P,) intensities at those points
    src_ok: jnp.ndarray,  # (P,) validity
    dst_image: jnp.ndarray,  # (H, W) destination intensity image
    intr: camera.Intrinsics,
    init_transform: jnp.ndarray | None = None,
    cfg: PhotometricConfig = PhotometricConfig(),
) -> PhotometricResult:
    """Direct image alignment of sampled source points onto dst_image."""
    # Pin to the framework compute dtype (f64 inputs under x64 would
    # break the fori_loop carry types).
    src_pts = jnp.asarray(src_pts, jnp.float32)
    src_intensity = jnp.asarray(src_intensity, jnp.float32)
    dst_image = jnp.asarray(dst_image, jnp.float32)
    T0 = (se3.identity() if init_transform is None
          else jnp.asarray(init_transform, jnp.float32))

    def residuals(T):
        return photometric_residuals(
            T, src_pts, src_intensity, dst_image, intr,
            min_depth=cfg.min_depth,
        )

    def weighted(T):
        r, ok = residuals(T)
        w = huber_weight(r, cfg.huber_delta) * (ok & src_ok).astype(r.dtype)
        return r, w

    def body(_, T):
        def r_of_twist(tw):
            return residuals(se3.compose(se3.exp(tw), T))[0]

        zero = jnp.zeros(6, jnp.float32)
        r, w = weighted(T)
        # (P, 6) Jacobian by forward-mode autodiff through projection AND
        # bilinear sampling (replaces sample.hpp's hand-chained jets).
        J = jax.jacfwd(r_of_twist)(zero)
        Jw = J * w[:, None]
        H = jnp.matmul(Jw.T, J, precision=jax.lax.Precision.HIGHEST)
        g = jnp.matmul(Jw.T, r, precision=jax.lax.Precision.HIGHEST)
        lam = cfg.damping * jnp.trace(H) + 1e-12
        delta = -jnp.linalg.solve(H + lam * jnp.eye(6, dtype=H.dtype), g)
        delta = jnp.where(jnp.all(jnp.isfinite(delta)), delta, jnp.zeros_like(delta))
        return se3.compose(se3.exp(delta), T)

    T = jax.lax.fori_loop(0, cfg.iters, body, T0)
    # Final statistics AT the returned transform (an in-loop value would
    # lag the pose it is reported with by one GN step).
    r, w = weighted(T)
    rmse = jnp.sqrt(jnp.sum(w * r * r) / jnp.maximum(jnp.sum(w), 1e-12))
    return PhotometricResult(
        transform=T, rmse=rmse, num_valid=jnp.sum(src_ok)
    )


def sample_intensity_points(depth, gray, intr, count: int, min_depth=0.05,
                            max_depth=10.0):
    """Stride-sample (points, intensities, ok) from a depth+gray frame pair.

    Thin wrapper over align.rgbd.sample_depth_gray_points (the single
    implementation of this sampling: static strided slices, no vertex map
    materialized)."""
    from realsensetracker_tpu.align.rgbd import sample_depth_gray_points

    return sample_depth_gray_points(depth, gray, intr, count,
                                    min_depth, max_depth)
