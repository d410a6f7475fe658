"""Masked fixed-capacity point clouds and basic reductions.

The reference's cloud container is cho::core::PointCloud<float,3> with
dynamic point counts (types.hpp:14-17), and NaN points are physically removed
(RemoveNans, point_cloud_utils.cpp:163-174). Dynamic shapes defeat XLA
compilation caching, so the device-side container is a fixed-capacity
(N, 3) array plus a boolean validity mask; "removal" is mask clearing and all
reductions are mask-weighted. This mirrors how SolveKabsch already supports
per-point weights (align_icp.cpp:38-56).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp


class Cloud(NamedTuple):
    """Fixed-capacity point cloud: points (..., N, 3), mask (..., N) bool."""

    points: jnp.ndarray
    mask: jnp.ndarray

    @property
    def capacity(self) -> int:
        return self.points.shape[-2]

    def count(self) -> jnp.ndarray:
        """Number of valid points (traced value)."""
        return jnp.sum(self.mask, axis=-1)


def from_points(points: jnp.ndarray, mask: jnp.ndarray | None = None) -> Cloud:
    if mask is None:
        mask = jnp.ones(points.shape[:-1], dtype=bool)
    return Cloud(points=points, mask=mask)


def mask_nonfinite(cloud: Cloud) -> Cloud:
    """Fixed-shape RemoveNans (ref point_cloud_utils.cpp:163-174).

    Instead of compacting the array (dynamic shape), clears the validity mask
    for any point with a non-finite coordinate and zeroes the data so later
    arithmetic never sees NaN/Inf.
    """
    finite = jnp.all(jnp.isfinite(cloud.points), axis=-1)
    mask = cloud.mask & finite
    points = jnp.where(mask[..., None], cloud.points, 0.0)
    return Cloud(points=points, mask=mask)


def centroid(cloud: Cloud) -> jnp.ndarray:
    """Mask-weighted centroid (ref ComputeCentroid, point_cloud_utils.cpp:92-98)."""
    w = cloud.mask.astype(cloud.points.dtype)
    total = jnp.sum(w, axis=-1)
    s = jnp.sum(cloud.points * w[..., None], axis=-2)
    return s / jnp.maximum(total, 1.0)[..., None]


def weighted_centroid(points: jnp.ndarray, weights: jnp.ndarray) -> jnp.ndarray:
    total = jnp.sum(weights, axis=-1)
    s = jnp.sum(points * weights[..., None], axis=-2)
    return s / jnp.maximum(total, 1e-12)[..., None]


def extents(cloud: Cloud) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Axis-aligned bounding box (ref ComputeExtents, point_cloud_utils.cpp:26-32)."""
    big = jnp.asarray(jnp.finfo(cloud.points.dtype).max, cloud.points.dtype)
    pts_min = jnp.where(cloud.mask[..., None], cloud.points, big)
    pts_max = jnp.where(cloud.mask[..., None], cloud.points, -big)
    return jnp.min(pts_min, axis=-2), jnp.max(pts_max, axis=-2)


def subsample_to_capacity(cloud: Cloud, capacity: int) -> Cloud:
    """Reduce a front-compacted cloud to `capacity` rows, spatially UNIFORM.

    Voxel-downsample survivors are compacted in sorted packed-key (x-major)
    order, so a head slice points[:capacity] would crop the high-x region
    of any cloud whose survivor count exceeds capacity. Instead take
    `capacity` evenly spaced survivors (exact pass-through when they fit).
    Requires valid rows compacted to the front (downsample_voxel's
    contract).
    """
    S = jnp.sum(cloud.mask).astype(jnp.int32)
    k = jnp.arange(capacity, dtype=jnp.int32)
    stride_idx = jnp.floor(
        k.astype(jnp.float32) * (S.astype(jnp.float32) / capacity)
    ).astype(jnp.int32)
    idx = jnp.where(S > capacity, jnp.minimum(stride_idx, S - 1), k)
    return Cloud(
        points=cloud.points[idx],
        mask=k < jnp.minimum(S, capacity),
    )


def pad_to_capacity(points, capacity: int, mask=None):
    """Pad host-side variable-length points up to a fixed capacity.

    Returns a Cloud whose first `n` entries are the input points. Points
    beyond capacity are dropped (callers choose capacity >= expected size).
    """
    import numpy as np

    points = np.asarray(points, dtype=np.float32)
    n = min(points.shape[0], capacity)
    out = np.zeros((capacity, 3), dtype=np.float32)
    out[:n] = points[:n]
    m = np.zeros((capacity,), dtype=bool)
    if mask is None:
        m[:n] = True
    else:
        m[:n] = np.asarray(mask)[:n]
    return Cloud(points=jnp.asarray(out), mask=jnp.asarray(m))
