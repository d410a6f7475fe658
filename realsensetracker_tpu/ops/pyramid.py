"""Depth/vertex pyramids for coarse-to-fine projective ICP.

The reference controls problem size with voxel downsampling
(rs_replay_app.cpp:246-247); the device hot path instead keeps frames on
the image grid and builds a pyramid by validity-aware 2x2 pooling. Pooling
and unprojection are plain XLA; each level's plane table is a Pallas
kernel on the GPU (ops/plane_kernel.py) and the same math in XLA
elsewhere.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from realsensetracker_tpu.geometry import camera
from realsensetracker_tpu.ops import plane_kernel


class PyramidLevel(NamedTuple):
    vertex_map: jnp.ndarray  # (H, W, 3)
    normal_map: jnp.ndarray  # (H, W, 3); zero where invalid
    valid: jnp.ndarray  # (H, W) bool: vertex AND normal valid
    vertex_valid: jnp.ndarray  # (H, W) bool: vertex valid (normals optional)
    packed: jnp.ndarray  # (4, H, W) planar PLANE table: [nx, ny, nz,
    # d = n . vertex]. Point-to-plane ICP only needs the destination's local
    # plane, so the hot-loop gather fetches 4 floats per correspondence
    # (residual r = n . p - d); invalid pixels carry n = 0 so their Jacobian
    # rows vanish and validity is |n|^2 > 0.5, costing nothing. Planar
    # layout keeps each plane contiguous over (H, W).


def downsample_depth(depth: jnp.ndarray, valid: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """2x2 validity-aware mean pooling of a depth map.

    A coarse pixel is valid if any of its 4 children are; its depth is the
    mean of valid children. Depth edges are handled by the downstream
    distance-compatibility gate in the ICP step rather than a median filter.
    """
    h, w = depth.shape[-2] // 2 * 2, depth.shape[-1] // 2 * 2
    d = depth[..., :h, :w].reshape(*depth.shape[:-2], h // 2, 2, w // 2, 2)
    m = valid[..., :h, :w].reshape(*valid.shape[:-2], h // 2, 2, w // 2, 2)
    cnt = jnp.sum(m, axis=(-3, -1))
    s = jnp.sum(jnp.where(m, d, 0.0), axis=(-3, -1))
    out_valid = cnt > 0
    out = jnp.where(out_valid, s / jnp.maximum(cnt, 1), 0.0)
    return out, out_valid


def level_intrinsics(
    intr: camera.Intrinsics, num_levels: int
) -> tuple[camera.Intrinsics, ...]:
    """Per-level intrinsics, fine to coarse -- THE single source of truth
    (build_pyramid and the sharded fast path both use it; a hand-rebuilt
    copy can silently diverge on odd dimensions)."""
    out = []
    cur = intr
    for _ in range(num_levels):
        out.append(cur)
        cur = cur.halved()
    return tuple(out)


def _shifted(a, di: int, dj: int, fill):
    """a[..., i + di, j + dj] over the last two axes, `fill` outside."""
    h, w = a.shape[-2], a.shape[-1]
    pad = [(0, 0)] * (a.ndim - 2) + [(1, 1), (1, 1)]
    ap = jnp.pad(a, pad, constant_values=fill)
    return ap[..., 1 + di:1 + di + h, 1 + dj:1 + dj + w]


def _plane_table_xla(d: jnp.ndarray, intr: camera.Intrinsics) -> jnp.ndarray:
    """Plane table of one level from its depth (H, W), 0 where invalid:
    (4, H, W) = [nx, ny, nz, n . v]. Normals are central-difference cross
    products oriented toward the camera; border pixels and pixels with an
    invalid (zero) 4-neighbour carry n = 0.

    Computed on (H, W) planes -- the vertex planes and their four shifted
    copies -- so XLA fuses it into a few loop fusions. The reference for
    ops/plane_kernel, and the path on every backend but the GPU.
    """
    h, w = d.shape[-2], d.shape[-1]
    u = jnp.arange(w, dtype=d.dtype)
    v = jnp.arange(h, dtype=d.dtype)[:, None]
    x = d * (u - intr.cx) * (1.0 / intr.fx)  # as camera.unproject_depth
    y = d * (v - intr.cy) * (1.0 / intr.fy)
    z = d
    valid = d > 0

    def diff(a, di, dj):  # a[+di, +dj] - a[-di, -dj]
        return _shifted(a, di, dj, 0.0) - _shifted(a, -di, -dj, 0.0)

    dux, duy, duz = diff(x, 0, 1), diff(y, 0, 1), diff(z, 0, 1)
    dvx, dvy, dvz = diff(x, 1, 0), diff(y, 1, 0), diff(z, 1, 0)
    nx = duy * dvz - duz * dvy
    ny = duz * dvx - dux * dvz
    nz = dux * dvy - duy * dvx
    norm = jnp.sqrt(nx * nx + ny * ny + nz * nz)
    ok = (valid & _shifted(valid, 0, 1, False) & _shifted(valid, 0, -1, False)
          & _shifted(valid, 1, 0, False) & _shifted(valid, -1, 0, False)
          & (norm > 1e-12))
    inv = 1.0 / jnp.maximum(norm, 1e-12)
    # Orient toward the camera at the origin (n . p < 0); zero if invalid.
    s = jnp.where(nx * x + ny * y + nz * z > 0, -inv, inv)
    s = jnp.where(ok, s, 0.0)
    nx, ny, nz = nx * s, ny * s, nz * s
    return jnp.stack([nx, ny, nz, nx * x + ny * y + nz * z], axis=0)


def plane_table(d: jnp.ndarray, intr: camera.Intrinsics) -> jnp.ndarray:
    """One level's plane table (4, H, W) from its depth (H, W), 0 where
    invalid (batch with jax.vmap): the Pallas kernel when lowered for a
    GPU, the XLA composition everywhere else. The choice is made per
    lowering platform, so a CPU computation in a GPU process still takes
    the XLA path."""
    return jax.lax.platform_dependent(
        d, cuda=lambda x: plane_kernel.plane_table(x, intr),
        default=lambda x: _plane_table_xla(x, intr))


def depth_to_meters(depth, scale=1.0):
    """Convert a raw depth frame (any leading batch dims) to f32 meters
    ON DEVICE.

    Integer frames (the native RealSense Z16 / TUM 16-bit PNG format)
    upload as uint16 -- HALF the host->device bytes of f32 -- and scale
    inside the compiled program, where XLA fuses the convert into the
    first pyramid level. Float frames are already meters; 0 stays 0 (invalid)."""
    if jnp.issubdtype(depth.dtype, jnp.integer):
        return depth.astype(jnp.float32) * jnp.float32(scale)
    return depth.astype(jnp.float32)


def build_pyramid(
    depth: jnp.ndarray,
    intr: camera.Intrinsics,
    num_levels: int = 3,
    min_depth: float = 0.05,
    max_depth: float = 10.0,
    with_normals: bool = True,
) -> tuple[list[PyramidLevel], list[camera.Intrinsics]]:
    """Depth image -> list of (vertex, normal, valid, packed) levels, fine to
    coarse.

    with_normals=False builds a SOURCE-role pyramid: projective point-to-
    plane ICP only reads the destination frame's normals, so source frames
    skip normal estimation and table packing entirely (the placeholder
    zeros are dead-code-eliminated by XLA when unused).

    The plane table (see plane_table) is parity-tested against the NumPy
    oracle (tests/reference_impl.build_pyramid_np).
    """
    levels: list[PyramidLevel] = []
    intrs: list[camera.Intrinsics] = []
    depth = depth.astype(jnp.float32)  # framework-wide compute dtype
    valid = camera.valid_mask(depth, min_depth, max_depth)
    # Invalid pixels carry depth 0, so valid == (d > 0) at every level (the
    # pooled depth is a mean of positive children): the plane table needs
    # only d.
    d = jnp.where(valid, depth, 0.0)
    cur_intr = intr
    for _ in range(num_levels):
        vmap = camera.unproject_depth(d, cur_intr)
        if with_normals:
            packed = plane_table(d, cur_intr)
            nmap = jnp.moveaxis(packed[0:3], 0, -1)
            lvl_valid = jnp.sum(packed[0:3] ** 2, axis=0) > 0.5
        else:
            nmap = jnp.zeros_like(vmap)
            lvl_valid = valid
            packed = jnp.zeros((4,) + vmap.shape[:-1], vmap.dtype)
        levels.append(
            PyramidLevel(
                vertex_map=vmap,
                normal_map=nmap,
                valid=lvl_valid,
                vertex_valid=valid,
                packed=packed,
            )
        )
        intrs.append(cur_intr)
        d, valid = downsample_depth(d, valid)
        cur_intr = cur_intr.halved()  # floor dims, matching downsample_depth
    return levels, intrs
