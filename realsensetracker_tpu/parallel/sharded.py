"""Point-sharded registration: shard_map + psum over the 6x6 normal equations.

The "tensor parallel" axis of this workload (SURVEY.md section 2, parallelism
inventory): sample points of one registration are split across chips, each
chip builds a partial H (6x6) / b (6) from its slice, and a jax.lax.psum
reduces them before the (tiny, replicated) solve. Combined with
the data axis this scales a single large registration AND a batch of them
across devices.

Structure (round 2): ALL per-frame preprocessing runs OUTSIDE the shard_map
region as ordinary sharded-batch XLA -- destination plane-table pyramids via
ops.pyramid.build_pyramid and source points via the
sampled-source fast path (projective.sample_depth_points; no source
vertex/normal maps are ever materialized). The shard_map region contains
ONLY the GN iteration loop: gather -> partial (H, b) -> psum -> solve.
This is the same fast path the unsharded flagship runs, so per-chip work
matches it; the only addition is one 6x6+6 psum per iteration.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from functools import lru_cache

from realsensetracker_tpu.align import projective
from realsensetracker_tpu.geometry import camera, se3
from realsensetracker_tpu.ops.pyramid import (
    PyramidLevel,
    build_pyramid,
    downsample_depth,
    level_intrinsics,
)


def _level_sample_counts(cfg: projective.ProjectiveIcpConfig, intr, num_levels):
    """Static per-level source sample counts (fine -> coarse), pre-padding."""
    counts = []
    h, w = intr.height, intr.width
    for li in range(num_levels):
        want = max(cfg.samples // (cfg.coarse_sample_divisor**li), cfg.min_samples)
        counts.append(min(want, h * w))
        h, w = h // 2, w // 2
    return counts


def _pad_to_multiple(pts, ok, multiple):
    """Pad the sample axis to a multiple of the point-axis size; padding
    carries ok=False so it contributes nothing to the psum'd reduction."""
    n = pts.shape[0]
    rem = (-n) % multiple
    if rem == 0:
        return pts, ok
    pts = jnp.concatenate([pts, jnp.zeros((rem, 3), pts.dtype)], axis=0)
    ok = jnp.concatenate([ok, jnp.zeros((rem,), bool)], axis=0)
    return pts, ok


def register_batch_point_sharded(
    mesh: Mesh,
    src_depths: jnp.ndarray,  # (B, H, W)
    dst_depths: jnp.ndarray,  # (B, H, W)
    intr: camera.Intrinsics,
    cfg: projective.ProjectiveIcpConfig = projective.ProjectiveIcpConfig(),
    data_axis: str = "data",
    point_axis: str = "point",
):
    """Register a batch with pairs sharded over `data_axis` and each pair's
    GN reduction sharded over `point_axis` (psum of H, b per iteration).

    Returns (transforms (B, 4, 4), rmse (B,)).

    The jitted preproc/GN programs are cached per (mesh, intr, cfg, axes):
    wrapping a fresh closure in jax.jit per call would retrace and
    recompile the full ICP program every invocation instead of one
    compile + cheap dispatches.
    """
    preproc_jit, run_jit = _point_sharded_programs(
        mesh, intr, cfg, data_axis, point_axis
    )
    packed, pts_levels, ok_levels = preproc_jit(src_depths, dst_depths)
    return run_jit(packed, pts_levels, ok_levels)


@lru_cache(maxsize=16)
def _point_sharded_programs(
    mesh: Mesh,
    intr: camera.Intrinsics,
    cfg: projective.ProjectiveIcpConfig,
    data_axis: str,
    point_axis: str,
):
    point_size = mesh.shape[point_axis]
    cfg = projective.fit_levels(cfg, int(intr.height), int(intr.width))
    num_levels = len(cfg.iters)
    counts = _level_sample_counts(cfg, intr, num_levels)
    # Per-level intrinsics: the same tuple feeds sampling AND the GN loop
    # (ops.pyramid.level_intrinsics is the single source of truth).
    intrs = level_intrinsics(intr, num_levels)

    # ---- Preprocessing: plain sharded-batch XLA ----
    def preproc_pair(src_depth, dst_depth):
        dst_levels, _ = build_pyramid(
            dst_depth, intr, num_levels, cfg.min_depth, cfg.max_depth
        )
        packed = tuple(lvl.packed for lvl in dst_levels)
        src_depth = src_depth.astype(jnp.float32)
        valid = camera.valid_mask(src_depth, cfg.min_depth, cfg.max_depth)
        d = jnp.where(valid, src_depth, 0.0)
        pts_levels, ok_levels = [], []
        for li in range(num_levels):
            pts, ok = projective.sample_depth_points(
                d, intrs[li], counts[li], cfg.min_depth, cfg.max_depth
            )
            pts, ok = _pad_to_multiple(pts, ok, point_size)
            pts_levels.append(pts)
            ok_levels.append(ok)
            d, valid = downsample_depth(d, valid)
        return packed, tuple(pts_levels), tuple(ok_levels)

    batch_sharding = jax.sharding.NamedSharding(mesh, P(data_axis))
    preproc_jit = jax.jit(
        jax.vmap(preproc_pair),
        in_shardings=(batch_sharding, batch_sharding),
    )

    # ---- GN loop: the only shard_map region (per-iteration psum of H, b) ---
    def gn_loop(packed_local, pts_local, ok_local):
        def one_pair(packed_pair, pts_pair, ok_pair):
            T = jax.lax.pcast(se3.identity(), (data_axis,), to="varying")
            rmse = jax.lax.pcast(jnp.float32(0.0), (data_axis,), to="varying")
            for li in range(num_levels - 1, -1, -1):  # coarse -> fine
                level_iters = cfg.iters[num_levels - 1 - li]
                dst_level = PyramidLevel(
                    vertex_map=None, normal_map=None, valid=None,
                    vertex_valid=None, packed=packed_pair[li],
                )
                local_pts_t = pts_pair[li].T  # lane-major, once per level
                local_ok = ok_pair[li]
                lvl_intr = intrs[li]

                def body(_, carry, dst_level=dst_level, lvl_intr=lvl_intr,
                         local_pts_t=local_pts_t, local_ok=local_ok):
                    T, _rmse = carry
                    # Associate once (local gather), then cfg.inner_iters GN
                    # updates against the fixed planes -- same outer/inner
                    # split as the unsharded flagship (projective._step);
                    # each inner step psums its partial normal equations.
                    n_t, d_pl, a_ok = projective.associate_planes_t(
                        T, local_pts_t, local_ok, dst_level, lvl_intr, cfg
                    )

                    def inner(_, c):
                        T_c, _r = c
                        H, b, aux = projective.normal_equations_fixed_t(
                            T_c, local_pts_t, n_t, d_pl, a_ok, cfg
                        )
                        # The collective: reduce partials across devices.
                        H, b, aux = jax.lax.psum((H, b, aux), axis_name=point_axis)
                        T_new, stats = projective.solve_update(
                            T_c, H, b, aux, cfg.samples, cfg
                        )
                        return T_new, stats[0]

                    if cfg.inner_iters <= 1:
                        return inner(0, (T, _rmse))
                    return jax.lax.fori_loop(0, cfg.inner_iters, inner, (T, _rmse))

                T, rmse = jax.lax.fori_loop(0, level_iters, body, (T, rmse))
            return T, rmse

        return jax.vmap(one_pair)(packed_local, pts_local, ok_local)

    run = jax.shard_map(
        gn_loop,
        mesh=mesh,
        in_specs=(
            tuple(P(data_axis) for _ in range(num_levels)),
            tuple(P(data_axis, point_axis) for _ in range(num_levels)),
            tuple(P(data_axis, point_axis) for _ in range(num_levels)),
        ),
        out_specs=(P(data_axis), P(data_axis)),
    )
    return preproc_jit, jax.jit(run)
