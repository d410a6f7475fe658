"""Pallas kernel (Triton route, for NVIDIA GPUs): one pyramid level's plane
table straight from its depth.

Same math as ops/pyramid._plane_table_xla, the reference it is tested
against. XLA splits that composition into several loop fusions that
materialize intermediate planes; this kernel reads the depth once (the
four neighbour loads hit in cache) and writes only the 16 B/px table.

Layout: the depth is flattened to (H * W,) and one program handles a
power-of-two block of consecutive pixels; the left/right/up/down
neighbours are masked loads at offsets -1, +1, -W, +W. Pixels on the
border, or with an invalid (zero) neighbour, get n = 0.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from realsensetracker_tpu.geometry import camera

BLOCK = 1024  # pixels per program (a power of two, as Triton requires)


def _kernel(d_ref, out_ref, *, h, w, fx, fy, cx, cy, block):
    n = h * w
    idx = pl.program_id(0) * block + jnp.arange(block, dtype=jnp.int32)
    inb = idx < n
    row = idx // w
    col = idx - row * w
    # Vertices exactly as camera.unproject_depth builds them (multiply by
    # the rounded reciprocal; Triton's float32 division is approximate).
    inv_fx, inv_fy, cx, cy = (jnp.float32(v)
                              for v in (1.0 / fx, 1.0 / fy, cx, cy))

    def vertex(di, dj, ok):
        src = jnp.clip(idx + di * w + dj, 0, n - 1)
        z = plgpu.load(d_ref.at[src], mask=inb & ok, other=0.0)
        u = (col + dj).astype(jnp.float32)
        v = (row + di).astype(jnp.float32)
        return z * (u - cx) * inv_fx, z * (v - cy) * inv_fy, z

    x, y, z = vertex(0, 0, inb)
    xr, yr, zr = vertex(0, 1, col < w - 1)
    xl, yl, zl = vertex(0, -1, col > 0)
    xd, yd, zd = vertex(1, 0, row < h - 1)
    xu, yu, zu = vertex(-1, 0, row > 0)
    dux, duy, duz = xr - xl, yr - yl, zr - zl
    dvx, dvy, dvz = xd - xu, yd - yu, zd - zu
    nx = duy * dvz - duz * dvy
    ny = duz * dvx - dux * dvz
    nz = dux * dvy - duy * dvx
    norm = jnp.sqrt(nx * nx + ny * ny + nz * nz)
    ok = ((z > 0) & (zr > 0) & (zl > 0) & (zd > 0) & (zu > 0)
          & (norm > 1e-12))
    inv = 1.0 / jnp.maximum(norm, 1e-12)
    s = jnp.where(nx * x + ny * y + nz * z > 0, -inv, inv)
    s = jnp.where(ok, s, 0.0)
    nx, ny, nz = nx * s, ny * s, nz * s
    d_plane = nx * x + ny * y + nz * z
    # Masked-off lanes keep distinct indices: a duplicated index would let
    # the interpreter's read-modify-write scatter race with the real lane.
    for k, plane in enumerate((nx, ny, nz, d_plane)):
        plgpu.store(out_ref.at[k * n + idx], plane, mask=inb)


@functools.partial(jax.jit, static_argnames=("intr", "interpret"))
def plane_table(d: jnp.ndarray, intr: camera.Intrinsics,
                interpret: bool = False) -> jnp.ndarray:
    """Depth (H, W) f32 meters with 0 where invalid -> plane table
    (4, H, W) = [nx, ny, nz, n . v]. Batch with jax.vmap."""
    h, w = d.shape
    kernel = functools.partial(_kernel, h=h, w=w, fx=intr.fx, fy=intr.fy,
                               cx=intr.cx, cy=intr.cy, block=BLOCK)
    out = pl.pallas_call(
        kernel,
        grid=(pl.cdiv(h * w, BLOCK),),
        out_shape=jax.ShapeDtypeStruct((4 * h * w,), jnp.float32),
        compiler_params=plgpu.CompilerParams(num_warps=4),
        interpret=interpret,
        name="plane_table",
    )(d.astype(jnp.float32).reshape(h * w))
    return out.reshape(4, h, w)
