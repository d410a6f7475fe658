"""Differentiable bilinear image sampling.

The reference carries libmv-derived bilinear sampling with hand-chained
ceres::Jet derivatives (sample.hpp:31-117, jet_extras.hpp:42-99 -- dead
code, included by nothing). Here the same capability is one jnp function:
jax autodiff differentiates through the bilinear weights for free, which is
what makes the photometric term (align/photometric.py) work without any
custom jet machinery.
"""

from __future__ import annotations

import jax.numpy as jnp


def bilinear_sample(image: jnp.ndarray, u: jnp.ndarray, v: jnp.ndarray):
    """Sample image (H, W) or (H, W, C) at float pixel coords (u, v).

    Returns (values, in_bounds_mask). Out-of-bounds samples clamp to the
    edge and are flagged invalid. Differentiable in u and v.
    """
    h, w = image.shape[0], image.shape[1]
    inb = (u >= 0) & (u <= w - 1) & (v >= 0) & (v <= h - 1)
    uc = jnp.clip(u, 0.0, w - 1.0)
    vc = jnp.clip(v, 0.0, h - 1.0)
    u0 = jnp.clip(jnp.floor(uc), 0, w - 2).astype(jnp.int32)
    v0 = jnp.clip(jnp.floor(vc), 0, h - 2).astype(jnp.int32)
    # Weights stay FLOAT: casting them to an integer image's dtype would
    # truncate every fraction to 0 (nearest-floor lookup, zero gradients).
    wdtype = image.dtype if jnp.issubdtype(image.dtype, jnp.floating) \
        else jnp.float32
    du = (uc - u0).astype(wdtype)
    dv = (vc - v0).astype(wdtype)
    if not jnp.issubdtype(image.dtype, jnp.floating):
        image = image.astype(wdtype)

    i00 = image[v0, u0]
    i01 = image[v0, u0 + 1]
    i10 = image[v0 + 1, u0]
    i11 = image[v0 + 1, u0 + 1]
    if image.ndim == 3:
        du = du[..., None]
        dv = dv[..., None]
    top = i00 * (1.0 - du) + i01 * du
    bot = i10 * (1.0 - du) + i11 * du
    return top * (1.0 - dv) + bot * dv, inb


def image_gradients(image: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Central-difference gradients (gx, gy) of an (H, W) image.

    Counterpart of the reference's precomputed gradient planes
    (sample.hpp:100-117); useful for fixed-linearization photometric GN.
    """
    gx = 0.5 * (jnp.roll(image, -1, axis=1) - jnp.roll(image, 1, axis=1))
    gy = 0.5 * (jnp.roll(image, -1, axis=0) - jnp.roll(image, 1, axis=0))
    gx = gx.at[:, 0].set(0.0).at[:, -1].set(0.0)
    gy = gy.at[0, :].set(0.0).at[-1, :].set(0.0)
    return gx, gy
