"""Voxel-hash world model, fixed capacity, device resident.

Device-resident CloudAccumulator (rs_replay_app.cpp:76-129): the reference keeps
an unordered_map voxel->point where the FIRST point to claim a voxel wins
(AddCloud, :95-107) and voxel indices use C truncation (GetVoxelIndex,
:109-111). Here the map is a fixed-capacity array + packed int32 voxel keys;
insertion is concat -> stable dedupe preferring existing entries, entirely
jittable so the model can stay on-device across a whole tracked sequence.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from realsensetracker_tpu.geometry import se3
from realsensetracker_tpu.ops import voxel
from realsensetracker_tpu.ops.cloud import Cloud

_BIG = jnp.int32(2**30)


class MapAccumulator(NamedTuple):
    points: jnp.ndarray  # (C, 3) world-frame points
    keys: jnp.ndarray  # (C,) packed voxel keys (int32)
    mask: jnp.ndarray  # (C,) occupancy

    @property
    def capacity(self) -> int:
        return self.points.shape[-2]

    def count(self):
        return jnp.sum(self.mask)

    def extract_cloud(self) -> Cloud:
        """ExtractPointCloud (rs_replay_app.cpp:113-122) equivalent."""
        return Cloud(points=self.points, mask=self.mask)


def init_map(capacity: int) -> MapAccumulator:
    return MapAccumulator(
        points=jnp.zeros((capacity, 3), jnp.float32),
        keys=jnp.full((capacity,), voxel._INVALID_KEY, jnp.int32),
        mask=jnp.zeros((capacity,), bool),
    )


@partial(jax.jit, static_argnames=("voxel_size",))
def add_cloud(
    acc: MapAccumulator, transform: jnp.ndarray, cloud: Cloud, voxel_size: float = 0.05
) -> MapAccumulator:
    """Insert a (camera-frame) cloud transformed to world; existing voxel
    entries win over new points (ref AddCloud first-insert semantics).

    World extent bound: keys persist across calls, so they CANNOT be
    recentered like downsample_voxel's are -- the packed 10-bit/axis key
    covers +-511 voxels around the world origin (+-25.6 m at the default
    0.05 m voxel). Geometry beyond that clamps into boundary voxels and
    stops accumulating; use the unbounded host map
    (native.voxel_map.NativeVoxelMap) for larger worlds."""
    C = acc.capacity
    # Pin to the framework compute dtype (callers may pass f64 under x64).
    p_w = se3.transform_points(
        jnp.asarray(transform, jnp.float32), cloud.points.astype(jnp.float32)
    )
    new_keys = voxel.pack_keys(
        voxel.voxel_coords(p_w, voxel_size, mode="trunc"), cloud.mask
    )

    all_pts = jnp.concatenate([acc.points, p_w], axis=0)  # (C + N, 3)
    all_keys = jnp.concatenate([acc.keys, new_keys], axis=0)
    n_all = all_keys.shape[0]

    order = jnp.argsort(all_keys, stable=True)  # ties: existing (lower pos) first
    sorted_keys = all_keys[order]
    is_head = jnp.concatenate(
        [jnp.ones(1, bool), sorted_keys[1:] != sorted_keys[:-1]]
    ) & (sorted_keys != voxel._INVALID_KEY)
    # Scatter head flags back to original positions, then keep the C
    # heads with the lowest original position (existing entries first ->
    # the map never evicts old voxels to admit new ones, mirroring the
    # reference's insert-only behavior).
    head_at_pos = jnp.zeros(n_all, bool).at[order].set(is_head)
    priority = jnp.where(head_at_pos, jnp.arange(n_all, dtype=jnp.int32), _BIG)
    surv = jnp.argsort(priority)[:C]
    surv_ok = priority[surv] < _BIG
    return MapAccumulator(
        points=jnp.where(surv_ok[:, None], all_pts[surv], 0.0),
        keys=jnp.where(surv_ok, all_keys[surv], voxel._INVALID_KEY),
        mask=surv_ok,
    )
