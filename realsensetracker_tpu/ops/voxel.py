"""Voxel-grid operations: downsampling and key quantization, fixed-shape.

The reference's DownsampleVoxel (point_cloud_utils.cpp:34-68) uses a CPU hash
map with first-point-wins insertion; its CloudAccumulator world model
(rs_replay_app.cpp:76-129) does the same with truncation instead of floor
(rs_replay_app.cpp:109-111). Hash maps have no fixed shape; the
equivalent here is quantize -> pack key -> stable sort -> segment-head mask,
which preserves the semantics exactly:

* one surviving point per occupied voxel;
* the survivor is the LOWEST-INDEX point of its voxel (stable sort ties on
  original order, matching unordered_map first-insert-wins);
* fixed-capacity output with a validity mask instead of a dynamic size.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from realsensetracker_tpu.ops.cloud import Cloud

# Packed voxel key layout: 10 bits per axis (coordinates clamped to +-511
# voxels around the origin) -> 30-bit non-negative int32 key. One spare key
# value marks invalid points so they sort to the end.
_KEY_BITS = 10
_KEY_OFFSET = 1 << (_KEY_BITS - 1)  # 512
_KEY_MAX = (1 << _KEY_BITS) - 1
_INVALID_KEY = jnp.int32(1 << 30)


def voxel_coords(points: jnp.ndarray, voxel_size: float, mode: str = "floor") -> jnp.ndarray:
    """Integer voxel coordinates. mode='floor' matches DownsampleVoxel
    (point_cloud_utils.cpp:41-42); mode='trunc' matches CloudAccumulator::
    GetVoxelIndex (rs_replay_app.cpp:109-111)."""
    scaled = points / voxel_size
    if mode == "floor":
        return jnp.floor(scaled).astype(jnp.int32)
    elif mode == "trunc":
        return scaled.astype(jnp.int32)  # C-style truncation toward zero
    raise ValueError(mode)


def pack_keys(coords: jnp.ndarray, mask: jnp.ndarray) -> jnp.ndarray:
    """Pack (N, 3) voxel coords into sortable non-negative int32 keys."""
    c = jnp.clip(coords + _KEY_OFFSET, 0, _KEY_MAX)
    key = (c[..., 0] << (2 * _KEY_BITS)) | (c[..., 1] << _KEY_BITS) | c[..., 2]
    return jnp.where(mask, key, _INVALID_KEY)


@partial(jax.jit, static_argnames=("voxel_size", "mode"))
def voxel_select_indices(cloud: Cloud, voxel_size: float, mode: str = "floor"):
    """Indices of surviving points (lowest index per voxel) + validity mask.

    The selection rule of the reference hash map: one point per occupied
    voxel, lowest original index wins. Survivors are compacted to the front
    in voxel-key order. Returning indices (not points) lets callers carry
    per-point attributes through the downsample.
    """
    n = cloud.capacity
    coords = voxel_coords(cloud.points, voxel_size, mode)
    # Recenter per cloud before packing: these keys only need uniqueness
    # WITHIN this call, so subtracting the masked minimum makes the packed
    # 10-bit range bind on cloud SPAN (> 1023 voxels per axis) instead of
    # distance from the origin -- a scene 6 m out at 1 cm voxels would
    # otherwise clamp wholesale into boundary voxels and be discarded.
    # (tracking/accumulator.py keys persist across calls and must NOT be
    # recentered; its world extent bound is documented there.)
    big = jnp.int32(1 << 30)
    cmin = jnp.min(jnp.where(cloud.mask[:, None], coords, big), axis=0)
    cmin = jnp.minimum(cmin, big - 1)  # all-invalid cloud: any shift works
    keys = pack_keys(coords - cmin - _KEY_OFFSET, cloud.mask)
    order = jnp.argsort(keys, stable=True)  # ties keep original index order
    sorted_keys = keys[order]
    is_head = jnp.concatenate(
        [jnp.ones(1, bool), sorted_keys[1:] != sorted_keys[:-1]]
    ) & (sorted_keys != _INVALID_KEY)
    count = jnp.sum(is_head)
    # Compact head positions to the front. Non-heads all target slot n-1;
    # that slot is only marked valid when count == n, in which case every
    # point is a head and nothing was parked there.
    dest = jnp.where(is_head, jnp.cumsum(is_head) - 1, n - 1)
    out_idx = jnp.zeros(n, dtype=jnp.int32).at[dest].set(order.astype(jnp.int32))
    out_mask = jnp.arange(n) < count
    return jnp.where(out_mask, out_idx, 0), out_mask


@partial(jax.jit, static_argnames=("voxel_size", "mode"))
def downsample_voxel(cloud: Cloud, voxel_size: float, mode: str = "floor") -> Cloud:
    """First-point-wins voxel downsample (ref point_cloud_utils.cpp:34-68),
    fixed capacity: survivors compacted to the front, mask marks real rows."""
    idx, mask = voxel_select_indices(cloud, voxel_size, mode)
    pts = jnp.where(mask[:, None], cloud.points[idx], 0.0)
    return Cloud(points=pts, mask=mask)
