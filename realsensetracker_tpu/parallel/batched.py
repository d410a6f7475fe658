"""Batched frame-pair registration: vmap on one chip, pjit across a mesh.

BASELINE config 4 ("64 frame pairs per step via vmap") and the data-parallel
half of config 5. Registrations are independent, so the only cross-device
communication is the optional throughput psum -- zero hot-loop
collectives.
"""

from __future__ import annotations

from functools import lru_cache, partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from realsensetracker_tpu.align import projective
from realsensetracker_tpu.geometry import camera


@partial(jax.jit, static_argnames=("intr", "cfg"))
def register_batch(
    src_depths: jnp.ndarray,  # (B, H, W)
    dst_depths: jnp.ndarray,  # (B, H, W)
    intr: camera.Intrinsics,
    cfg: projective.ProjectiveIcpConfig = projective.ProjectiveIcpConfig(),
) -> projective.ProjectiveIcpResult:
    """Register B independent frame pairs in one compiled step (vmap)."""
    fn = jax.vmap(lambda s, d: projective.register_depth_pair(s, d, intr, cfg))
    return fn(src_depths, dst_depths)


@partial(jax.jit, static_argnames=("intr", "cfg", "chunk"))
def register_batch_chunked(
    src_depths: jnp.ndarray,  # (B, H, W), B a multiple of chunk
    dst_depths: jnp.ndarray,
    intr: camera.Intrinsics,
    cfg: projective.ProjectiveIcpConfig = projective.ProjectiveIcpConfig(),
    chunk: int = 512,
) -> projective.ProjectiveIcpResult:
    """Register B pairs as a lax.scan of `chunk`-sized vmapped steps.

    One dispatch processes many chunks, while the device-memory high-water
    mark stays at one chunk's working set (XLA reuses the scan body's
    buffers across iterations). The default chunk=512 at 640x480 was sized
    for a 16 GB device; sizing it from the card's memory is open
    (ROADMAP.md).
    """
    b = src_depths.shape[0]
    if b <= chunk:
        return register_batch(src_depths, dst_depths, intr, cfg)
    assert b % chunk == 0, f"batch {b} not a multiple of chunk {chunk}"
    shape = (b // chunk, chunk) + src_depths.shape[1:]

    def body(carry, sd):
        s, d = sd
        return carry, register_batch(s, d, intr, cfg)

    _, res = jax.lax.scan(
        body, 0, (src_depths.reshape(shape), dst_depths.reshape(shape))
    )
    return jax.tree.map(lambda x: x.reshape((b,) + x.shape[2:]), res)


def register_batch_sharded(
    mesh: Mesh,
    src_depths: jnp.ndarray,
    dst_depths: jnp.ndarray,
    intr: camera.Intrinsics,
    cfg: projective.ProjectiveIcpConfig = projective.ProjectiveIcpConfig(),
    data_axis: str = "data",
) -> projective.ProjectiveIcpResult:
    """Data-parallel batched registration across the mesh's data axis.

    Inputs are sharded over the batch dimension; XLA partitions the whole
    pipeline (pyramids + GN iterations) with no communication between pairs.
    The jitted program is cached per (mesh, intr, cfg, axis) -- a fresh
    closure in jax.jit per call would recompile every invocation.
    """
    batch_sharding = NamedSharding(mesh, P(data_axis))
    fn = _sharded_register_program(mesh, intr, cfg, data_axis)
    src = jax.device_put(src_depths, batch_sharding)
    dst = jax.device_put(dst_depths, batch_sharding)
    return fn(src, dst)


@lru_cache(maxsize=16)
def _sharded_register_program(mesh, intr, cfg, data_axis):
    batch_sharding = NamedSharding(mesh, P(data_axis))
    return jax.jit(
        lambda s, d: register_batch(s, d, intr, cfg),
        in_shardings=(batch_sharding, batch_sharding),
        out_shardings=projective.ProjectiveIcpResult(
            transform=batch_sharding,
            rmse=batch_sharding,
            inlier_fraction=batch_sharding,
            num_matched=batch_sharding,
        ),
    )
