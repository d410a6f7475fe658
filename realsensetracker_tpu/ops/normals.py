"""Surface normal estimation on unorganized clouds: kNN/PCA (parity).

Reference: ComputeNormals (point_cloud_utils.cpp:176-204) does a per-point
kNN -> neighborhood covariance -> SelfAdjointEigenSolver, taking the
eigenvector of the smallest eigenvalue; OrientNormals (:206-216) flips
normals to face the viewpoint. Here:

* `knn_pca_normals` reproduces those semantics exactly with batched dense
  kNN + batched 3x3 eigendecomposition (vmap over points).

Organized depth images take the image-grid path instead
(ops/pyramid.plane_table): central differences, a cross product, no
neighbor search -- what feeds projective point-to-plane ICP.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from realsensetracker_tpu.ops import correspond
from realsensetracker_tpu.ops.cloud import Cloud


@partial(jax.jit, static_argnames=("k",))
def knn_pca_normals(cloud: Cloud, k: int = 16) -> jnp.ndarray:
    """Per-point PCA normals over k nearest neighbors (self included).

    Matches reference ComputeNormals (point_cloud_utils.cpp:176-204): the
    kNN set includes the query point itself (it is in the search tree), the
    covariance is the *unnormalized* scatter matrix, and the normal is the
    smallest-eigenvalue eigenvector.
    """
    idx, d2 = correspond.knn(cloud.points, cloud, k)
    # Weight out _BIG-distance padding (fewer than k valid candidates):
    # phantom zero-rows would otherwise rotate sparse-cloud normals toward
    # the origin. The C++ tree always has >= k real points.
    real = d2 < 1e29
    wn = real.astype(cloud.points.dtype)[..., None]
    cnt = jnp.maximum(jnp.sum(real, axis=-1), 1).astype(cloud.points.dtype)
    nbrs = cloud.points[idx] * wn  # (N, k, 3)
    ctr = jnp.sum(nbrs, axis=-2, keepdims=True) / cnt[:, None, None]
    delta = (cloud.points[idx] - ctr) * wn
    cov = jnp.einsum("nki,nkj->nij", delta, delta,
                     precision=jax.lax.Precision.HIGHEST)
    # eigh returns ascending eigenvalues; column 0 = smallest, as Eigen's
    # SelfAdjointEigenSolver eigenvectors().col(0).
    _, vecs = jnp.linalg.eigh(cov)
    return vecs[..., :, 0]


def orient_normals(
    points: jnp.ndarray, normals: jnp.ndarray, viewpoint: jnp.ndarray
) -> jnp.ndarray:
    """Flip normals so they face the viewpoint (ref OrientNormals,
    point_cloud_utils.cpp:206-216: flip when (p - viewpoint) . n > 0)."""
    ray = points - viewpoint
    flip = jnp.sum(ray * normals, axis=-1) > 0
    return jnp.where(flip[..., None], -normals, normals)
