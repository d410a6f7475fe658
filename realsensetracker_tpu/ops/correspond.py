"""Correspondence search: brute-force (dense matmul) and projective association.

The reference finds correspondences with per-point nanoflann KD-tree queries
(FindCorrespondences, point_cloud_utils.cpp:70-90; the ICP hot loop,
align_icp.cpp:105-121). Pointer-chasing trees are hostile to accelerators;
instead:

1. `nearest_neighbors` / `knn`: dense brute-force search. The pairwise
   squared-distance matrix is computed as |a|^2 + |b|^2 - 2 a.b^T -- one big
   matmul. Exact 1-NN semantics (parity path with the
   reference's trees). Chunked over the query axis to bound memory.
2. `projective_lookup` (in align/projective.py): O(1) per-point association
   via camera projection into the destination vertex map -- the production
   hot path per the north star.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from realsensetracker_tpu.ops.cloud import Cloud

_BIG = 1e30


def pairwise_sqdist(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Squared distances (..., N, M) between a (..., N, D) and b (..., M, D).

    The cross term is a matmul. precision=HIGHEST is load-bearing for
    the EXACT-1-NN contract: default precision may round operands to bf16
    or TF32 (~4e-3 / ~5e-4 relative), which can flip argmin to a
    neighbor tens of centimeters off at meter-scale coordinates --
    preferred_element_type alone only fixes the accumulator, not the
    operand rounding.
    """
    a2 = jnp.sum(a * a, axis=-1)
    b2 = jnp.sum(b * b, axis=-1)
    cross = jnp.matmul(
        a, jnp.swapaxes(b, -1, -2),
        precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=jnp.float32,
    )
    d2 = a2[..., :, None] + b2[..., None, :] - 2.0 * cross
    return jnp.maximum(d2, 0.0)


def _masked_sqdist(q: jnp.ndarray, dst: Cloud) -> jnp.ndarray:
    d2 = pairwise_sqdist(q, dst.points)
    return jnp.where(dst.mask[..., None, :], d2, _BIG)


@partial(jax.jit, static_argnames=("chunk",))
def nearest_neighbors(
    src_points: jnp.ndarray, dst: Cloud, chunk: int = 2048
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Exact 1-NN of each src point among valid dst points.

    Returns (indices (N,), squared_distances (N,)). Matches the semantics of
    the reference's FindCorrespondences (point_cloud_utils.cpp:70-90) on the
    set of valid points. Invalid dst points can never be selected.
    """
    n = src_points.shape[0]
    pad = (-n) % chunk
    q = jnp.pad(src_points, ((0, pad), (0, 0)))
    q = q.reshape(-1, chunk, src_points.shape[-1])

    def body(qc):
        d2 = _masked_sqdist(qc, dst)
        idx = jnp.argmin(d2, axis=-1)
        return idx, jnp.take_along_axis(d2, idx[:, None], axis=-1)[:, 0]

    idx, d2 = jax.lax.map(body, q)
    return idx.reshape(-1)[:n], d2.reshape(-1)[:n]


@partial(jax.jit, static_argnames=("k", "chunk"))
def knn(
    src_points: jnp.ndarray, dst: Cloud, k: int, chunk: int = 1024
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Exact k-NN: returns (indices (N, k), squared_distances (N, k)).

    Dense equivalent of nanoflann knnSearch with k results (kdtree.hpp:51-57),
    implemented as chunked dense distances + top-k (negated for smallest).
    """
    n = src_points.shape[0]
    pad = (-n) % chunk
    q = jnp.pad(src_points, ((0, pad), (0, 0)))
    q = q.reshape(-1, chunk, src_points.shape[-1])

    def body(qc):
        d2 = _masked_sqdist(qc, dst)
        neg_d2, idx = jax.lax.top_k(-d2, k)
        return idx, -neg_d2

    idx, d2 = jax.lax.map(body, q)
    return idx.reshape(-1, k)[:n], d2.reshape(-1, k)[:n]


@partial(jax.jit, static_argnames=("k", "chunk"))
def knn_self(points: Cloud, k: int, chunk: int = 1024):
    """k nearest neighbors of each point within the same cloud, excluding self.

    Mirrors the reference's kNeighbors+1-then-skip-self pattern
    (ComputeCovariances, point_cloud_utils.cpp:104-127). Self-matches are
    excluded by masking zero-distance-at-own-index entries.
    """
    n = points.capacity
    pad = (-n) % chunk
    q = jnp.pad(points.points, ((0, pad), (0, 0)))
    q = q.reshape(-1, chunk, 3)
    base = jnp.arange(0, n + pad, chunk)

    def body(args):
        qc, start = args
        d2 = _masked_sqdist(qc, points)
        row = jnp.arange(chunk) + start
        col = jnp.arange(n)
        self_mask = row[:, None] == col[None, :]
        d2 = jnp.where(self_mask, _BIG, d2)
        neg_d2, idx = jax.lax.top_k(-d2, k)
        return idx, -neg_d2

    idx, d2 = jax.lax.map(body, (q, base))
    return idx.reshape(-1, k)[:n], d2.reshape(-1, k)[:n]
