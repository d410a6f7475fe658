"""FPFH (Fast Point Feature Histograms), dense masked formulation.

Reference: fpfh.cpp. The C++ computes, per point, a radius neighborhood
(nanoflann radiusSearch), the Darboux-frame pair features (ComputePfh,
fpfh.cpp:21-67), a 3x11-bin SPFH histogram (ComputeSpfh, :69-112), then the
1/distance-weighted neighbor accumulation + per-segment normalization
(ComputeFpfhImpl, :114-176). Feature matching is 33-D KD-tree kNN
(ComputeMatch/ComputeMatches, :263-303).

Dense rebuild: neighborhoods become a fixed-K kNN (dense distances)
intersected with the radius ball; pair features evaluate for all (i, k)
lanes at once; histograms scatter via one-hot matmuls; matching reuses the
dense kNN. Exact reference semantics preserved:

* symmetric origin switch when |n1.d| < |n2.d| (fpfh.cpp:38-48);
* zero-distance and |u_d| >= 1 pairs contribute nothing (:27, :54);
* bin = clamp(floor(11 * (f * scale + 0.5)), 0, 10), scale = (1/2pi, .5, .5)
  (:75, :93-95);
* SPFH weight 1/(n_neighbors - 1) counting self (:77);
* FPFH excludes own SPFH (PCL convention, :154) and normalizes each 11-bin
  segment to unit sum (:169-174).
"""

from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp

from realsensetracker_tpu.ops import correspond, normals as normals_mod
from realsensetracker_tpu.ops.cloud import Cloud

NUM_BINS = 11  # kNumBins, fpfh.cpp:14
FPFH_SIZE = 3 * NUM_BINS  # kFpfhSize, fpfh.cpp:15
_SCALE = (1.0 / (2.0 * math.pi), 0.5, 0.5)  # fpfh.cpp:75


def pair_features(p1, n1, p2, n2):
    """Darboux pair features for stacked pairs (..., 3) -> ((..., 3), valid).

    Vectorized ComputePfh (fpfh.cpp:21-67) with identical switch/guard
    semantics, NaN-free via masked denominators.
    """
    delta = p2 - p1
    dist = jnp.linalg.norm(delta, axis=-1)
    ok = dist > 0.0
    inv = jnp.where(ok, 1.0 / jnp.maximum(dist, 1e-30), 0.0)
    d = delta * inv[..., None]

    n1_d = jnp.sum(n1 * d, axis=-1)
    n2_d = jnp.sum(n2 * d, axis=-1)
    switch = jnp.abs(n1_d) < jnp.abs(n2_d)  # fpfh.cpp:41
    u_d = jnp.where(switch, -n2_d, n1_d)
    nt_d = jnp.where(switch, -n1_d, n2_d)

    ok = ok & (jnp.abs(u_d) < 1.0)  # fpfh.cpp:54
    v_norm = jnp.sqrt(jnp.maximum(1.0 - u_d * u_d, 0.0))
    inv_v = jnp.where(ok, 1.0 / jnp.maximum(v_norm, 1e-30), 0.0)
    n1n2 = jnp.sum(n1 * n2, axis=-1)
    f0 = jnp.arctan2(nt_d - n1n2 * u_d, n1n2 * v_norm)  # f4, fpfh.cpp:62
    f1 = jnp.sum(d * jnp.cross(n1, n2), axis=-1) * inv_v  # f1, fpfh.cpp:63
    f2 = u_d  # f3, fpfh.cpp:64
    feats = jnp.stack([f0, f1, f2], axis=-1)
    return jnp.where(ok[..., None], feats, 0.0), ok


def _histogram(feats, weights):
    """(..., K, 3) features + (..., K) weights -> (..., 33) histogram."""
    scale = jnp.asarray(_SCALE, feats.dtype)
    raw = jnp.floor(NUM_BINS * (feats * scale + 0.5)).astype(jnp.int32)
    bins = jnp.clip(raw, 0, NUM_BINS - 1)  # fpfh.cpp:95
    onehot = jax.nn.one_hot(bins, NUM_BINS, dtype=feats.dtype)  # (..., K, 3, 11)
    hist = jnp.einsum("...kfb,...k->...fb", onehot, weights,
                      precision=jax.lax.Precision.HIGHEST)
    return hist.reshape(hist.shape[:-2] + (FPFH_SIZE,))


@partial(jax.jit, static_argnames=("max_neighbors",))
def compute_spfh(
    cloud: Cloud, normals: jnp.ndarray, radius: float, max_neighbors: int = 64
):
    """SPFH histograms (N, 33) + neighborhood (idx, nbr_ok, dist, truncated).

    Neighborhood = K nearest within `radius` (self included), capped at
    max_neighbors; choose the cap >= the densest true ball for exact parity.
    `truncated` (scalar bool) reports whether any point's true radius ball
    exceeds the cap -- detected from the (K+1)-th nearest neighbor, which
    the dense kNN pass provides for free (vs the separate O(N^2)
    ball_counts sweep).
    """
    k = min(max_neighbors, cloud.capacity)
    k_probe = min(k + 1, cloud.capacity)  # +1 column: truncation detector
    idx_p, _ = correspond.knn(cloud.points, cloud, k_probe)  # self included
    idx = idx_p[:, :k]
    p1 = cloud.points[:, None, :]  # (N, 1, 3)
    p2 = cloud.points[idx]  # (N, K, 3)
    # Exact distances (matmul-form d2 loses precision near zero).
    dist = jnp.linalg.norm(p2 - p1, axis=-1)
    if k_probe > k:
        d_probe = jnp.linalg.norm(cloud.points[idx_p[:, k]] - cloud.points, axis=-1)
        truncated = jnp.any(
            (d_probe <= radius) & cloud.mask[idx_p[:, k]] & cloud.mask
        )
    else:
        truncated = jnp.asarray(False)
    nbr_ok = (dist <= radius) & cloud.mask[idx] & cloud.mask[:, None]
    is_self = idx == jnp.arange(cloud.capacity)[:, None]

    n1 = jnp.broadcast_to(normals[:, None, :], p2.shape)
    n2 = normals[idx]
    feats, pfh_ok = pair_features(p1, n1, p2, n2)

    n_nbrs = jnp.sum(nbr_ok, axis=-1)  # counts self, as radiusSearch does
    dhist = jnp.where(n_nbrs > 1, 1.0 / jnp.maximum(n_nbrs - 1, 1), 0.0)  # fpfh.cpp:77
    w = (nbr_ok & ~is_self & pfh_ok).astype(feats.dtype) * dhist[:, None]
    spfh = _histogram(feats, w)
    return spfh, idx, nbr_ok, dist, truncated


@partial(jax.jit, static_argnames=("max_neighbors",))
def compute_fpfh_from_normals_checked(
    cloud: Cloud, normals: jnp.ndarray, radius: float, max_neighbors: int = 64
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """FPFH features (N, 33) + scalar `truncated` flag (see compute_spfh)
    given precomputed oriented normals.

    Mirrors ComputeFpfhImpl (fpfh.cpp:114-176): fpfh_i = sum over radius
    neighbors j != i of spfh_j / dist_ij, then per-segment unit-sum
    normalization.
    """
    spfh, idx, nbr_ok, dist, truncated = compute_spfh(
        cloud, normals, radius, max_neighbors
    )
    is_self = idx == jnp.arange(cloud.capacity)[:, None]
    contrib_ok = nbr_ok & ~is_self & (dist > 0)
    w = jnp.where(contrib_ok, 1.0 / jnp.maximum(dist, 1e-30), 0.0)  # fpfh.cpp:164-165
    feat = jnp.einsum("nk,nkf->nf", w, spfh[idx],
                      precision=jax.lax.Precision.HIGHEST)
    seg = feat.reshape(-1, 3, NUM_BINS)
    seg_sum = jnp.sum(seg, axis=-1, keepdims=True)
    seg = jnp.where(seg_sum > 0, seg / jnp.maximum(seg_sum, 1e-30), seg)  # :169-174
    return seg.reshape(-1, FPFH_SIZE), truncated


def compute_fpfh_from_normals(
    cloud: Cloud, normals: jnp.ndarray, radius: float, max_neighbors: int = 64
) -> jnp.ndarray:
    """FPFH features (N, 33); see compute_fpfh_from_normals_checked."""
    return compute_fpfh_from_normals_checked(cloud, normals, radius, max_neighbors)[0]


@partial(jax.jit, static_argnames=("normal_k", "max_neighbors"))
def compute_fpfh_checked(
    cloud: Cloud,
    viewpoint: jnp.ndarray,
    normal_k: int = 16,
    feature_radius: float = 0.5,
    max_neighbors: int = 64,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Full pipeline of ComputeFpfh (fpfh.cpp:238-254): kNN-PCA normals ->
    viewpoint orientation -> FPFH. Also returns the scalar ball-truncation
    flag (free byproduct of the kNN pass, compute_spfh)."""
    n = normals_mod.knn_pca_normals(cloud, k=normal_k)
    n = normals_mod.orient_normals(cloud.points, n, viewpoint)
    return compute_fpfh_from_normals_checked(cloud, n, feature_radius, max_neighbors)


def compute_fpfh(
    cloud: Cloud,
    viewpoint: jnp.ndarray,
    normal_k: int = 16,
    feature_radius: float = 0.5,
    max_neighbors: int = 64,
) -> jnp.ndarray:
    """Full FPFH pipeline; see compute_fpfh_checked."""
    return compute_fpfh_checked(
        cloud, viewpoint, normal_k, feature_radius, max_neighbors
    )[0]


@partial(jax.jit, static_argnames=("chunk",))
def ball_counts(cloud: Cloud, radius: float, chunk: int = 1024) -> jnp.ndarray:
    """Per-point occupancy of the radius ball (valid neighbors, self incl.).

    The C++ uses a true radiusSearch (fpfh.cpp:133-147) while the dense
    formulation caps the neighborhood at a static kNN size
    (compute_spfh); this measures the true ball so callers can size the
    cap instead of silently truncating. Chunked dense distances: O(N^2)
    like the kNN itself, (chunk, N) working set.
    """
    n = cloud.capacity
    pad = (-n) % chunk
    pts = jnp.pad(cloud.points.astype(jnp.float32), ((0, pad), (0, 0)))
    msk = jnp.pad(cloud.mask, (0, pad))
    r2 = jnp.float32(radius) ** 2
    all_pts = cloud.points.astype(jnp.float32)

    def body(carry, xs):
        pc, mc = xs
        d2 = jnp.sum((pc[:, None, :] - all_pts[None, :, :]) ** 2, axis=-1)
        cnt = jnp.sum((d2 <= r2) & cloud.mask[None, :], axis=-1)
        return carry, jnp.where(mc, cnt, 0)

    _, counts = jax.lax.scan(
        body, 0, (pts.reshape(-1, chunk, 3), msk.reshape(-1, chunk))
    )
    return counts.reshape(-1)[:n]


def densest_ball_count(cloud: Cloud, radius: float) -> int:
    """Occupancy of the densest radius ball (host int, self included)."""
    return int(jnp.max(ball_counts(cloud, radius)))


def ball_truncated(cloud: Cloud, radius: float, max_neighbors: int) -> bool:
    """True if any point's radius ball exceeds `max_neighbors`, i.e. the
    static kNN cap would silently drop radiusSearch neighbors
    (fpfh.cpp:133-147 semantics). Use densest_ball_count / auto_max_neighbors
    to size the cap so this never fires."""
    return densest_ball_count(cloud, radius) > max_neighbors


def auto_max_neighbors(*clouds_radius: tuple[Cloud, float], floor: int = 32) -> int:
    """Smallest multiple-of-16 cap that provably covers every radius ball
    of every given (cloud, radius) pair. Multiple-of-16 keeps the set of
    distinct jit shapes (compute_spfh is static in the cap) small."""
    need = floor
    for cloud, radius in clouds_radius:
        need = max(need, densest_ball_count(cloud, radius))
    k = (need + 15) // 16 * 16
    return min(k, max(c.capacity for c, _ in clouds_radius)) if clouds_radius else k


@partial(jax.jit, static_argnames=("num_matches",))
def compute_matches(
    src_fpfh: jnp.ndarray,
    dst_fpfh: jnp.ndarray,
    src_mask: jnp.ndarray,
    dst_mask: jnp.ndarray,
    num_matches: int = 2,
):
    """k-NN in 33-D feature space (ref ComputeMatches, fpfh.cpp:282-296).

    Returns (indices (N, k), squared distances (N, k))."""
    dst = Cloud(points=dst_fpfh, mask=dst_mask)
    idx, d2 = correspond.knn(src_fpfh, dst, num_matches)
    del src_mask  # invalid sources produce matches; callers mask downstream
    return idx, d2


def prune_matches_lowe(
    matches: jnp.ndarray,  # (N, 2) candidate dst indices
    src_fpfh: jnp.ndarray,
    dst_fpfh: jnp.ndarray,
    lowe_ratio: float = 0.9,
    src_mask: jnp.ndarray | None = None,
):
    """Lowe ratio test + Gaussian feature-distance weights.

    Vectorized PruneMatchesLowe (rs_align_app.cpp:177-217): recompute both
    feature distances, keep the closer candidate when d_best <
    lowe_ratio * d_other, weight = exp(-d_best / 0.25^2). Fixed shape:
    returns (dst_index (N,), weight (N,), keep (N,)).
    """
    f_src = src_fpfh
    f0 = dst_fpfh[matches[:, 0]]
    f1 = dst_fpfh[matches[:, 1]]
    d0 = jnp.sum((f_src - f0) ** 2, axis=-1)
    d1 = jnp.sum((f_src - f1) ** 2, axis=-1)
    first_closer = d0 < d1
    d_best = jnp.where(first_closer, d0, d1)
    d_other = jnp.where(first_closer, d1, d0)
    j_best = jnp.where(first_closer, matches[:, 0], matches[:, 1])
    keep = d_best < lowe_ratio * d_other
    if src_mask is not None:
        keep = keep & src_mask
    k_var = 0.25 * 0.25  # rs_align_app.cpp:199
    weight = jnp.exp(-d_best / k_var)
    return j_best, jnp.where(keep, weight, 0.0), keep
