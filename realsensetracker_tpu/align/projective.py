"""Projective point-to-plane ICP: the production registration path.

This replaces the reference's tree-based inner loop (align_icp.cpp:105-121)
per the north star: correspondence is O(1) camera projection into the
destination vertex/normal maps, the residual is point-to-plane, and the pose
update solves 6x6 Gauss-Newton normal equations on se(3) -- all fixed-shape,
fully inside jit, batched with vmap.

Robustness follows the reference's spirit: a Geman-McClure/GNC weight on the
residual (align_icp.cpp:116-118 uses l=(mu/(d^2+mu))^2; here the same form on
the point-to-plane residual) plus distance/normal compatibility gates, and
Levenberg damping standing in for Ceres LM (align_gicp.cpp:20-21).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Sequence

import jax
import jax.numpy as jnp

from realsensetracker_tpu.geometry import camera, se3
from realsensetracker_tpu.ops.pyramid import PyramidLevel


class ProjectiveIcpConfig(NamedTuple):
    """Static solver configuration (hashable -> usable as jit static arg)."""

    iters: tuple[int, ...] = (3, 3, 3, 2)  # association rounds per level,
    # coarse -> fine order; 4 levels (coarsest 80x60 at 640x480).
    # GN steps per correspondence set: each level round gathers planes
    # ONCE, then applies `inner_iters` Gauss-Newton updates against those
    # fixed planes (the reference's outer/inner split, align_gicp.cpp:
    # 134-159, applied to projective ICP). The gather is the hot-loop
    # bottleneck: x2 inner halves the gathers at equal
    # small-motion accuracy (twist err ~8e-5 at 640x480), and the 4th
    # pyramid level restores the basin edge the shorter 3-level schedule
    # lost (18-case 0.08-0.12 rad/m sweep: 3 failures, same as the old
    # (6,5,4) x 1, vs 6 for 3-level (3,3,2) x 2).
    inner_iters: int = 2
    samples: int = 2048  # source points sampled at the FINEST level
    sample_mode: str = "stride"  # "stride" | "normal_space" (config 3)
    coarse_sample_divisor: int = 4  # level l uses samples / divisor**l
    min_samples: int = 256  # floor for the coarsest levels
    dist_threshold: float = 0.25  # meters; plane-distance correspondence gate
    gnc_mu: float = 1e-2  # GNC weight scale on plane residual^2
    damping: float = 1e-6  # Levenberg damping (relative to trace)
    min_depth: float = 0.05
    max_depth: float = 10.0


def fit_levels(cfg, height: int, width: int, min_extent: int = 24):
    """Truncate ``cfg.iters`` so the coarsest pyramid level keeps its
    smaller image dimension >= ``min_extent`` pixels.

    The default 4-level schedule assumes ~640x480 (coarsest 80x60); at
    80x60 TEST resolution the 10x7 coarsest level carries too few valid
    planes to constrain a 6-DOF solve and the whole cascade can diverge
    (hit twice by tests at small resolutions). ``iters`` is coarse->fine, so dropping the unusable COARSE
    entries keeps fine-level behavior identical; at production
    resolutions this is a no-op. Works on any config NamedTuple with an
    ``iters`` tuple (ProjectiveIcpConfig, RgbdIcpConfig). Shape-static:
    safe to call at trace time.
    """
    levels = len(cfg.iters)
    e = min(int(height), int(width))
    max_levels = 1
    while max_levels < levels and (e >> max_levels) >= min_extent:
        max_levels += 1
    if max_levels >= levels:
        return cfg
    return cfg._replace(iters=cfg.iters[levels - max_levels:])


class ProjectiveIcpResult(NamedTuple):
    transform: jnp.ndarray  # (4, 4)
    rmse: jnp.ndarray  # weighted point-to-plane RMSE at finest level
    inlier_fraction: jnp.ndarray  # fraction of sampled points matched
    num_matched: jnp.ndarray


def sample_level(level: PyramidLevel, count: int):
    """Deterministic stride subsample of valid-ish pixels at one level.

    Fixed-shape (count,) gather; invalid samples carry zero weight.
    Stand-in for the reference's voxel downsample of the source cloud
    (rs_replay_app.cpp:246): bounds per-iteration work independent of
    resolution.
    """
    h, w = level.valid.shape
    npix = h * w
    count = min(count, npix)
    stride = npix // count
    # Static strided SLICE, not a gather: the indices are arange(count) *
    # stride, so lax.slice with a stride reads the same elements without the
    # per-row index reads an advanced-index gather costs.
    lim = count * stride
    pts = level.vertex_map.reshape(npix, 3)[:lim:stride]
    nrm = level.normal_map.reshape(npix, 3)[:lim:stride]
    ok = level.valid.reshape(npix)[:lim:stride]
    return pts, nrm, ok


def sample_level_normal_space(level: PyramidLevel, count: int, bins: int = 6):
    """Normal-space sampling (BASELINE config 3): pick samples balanced
    across surface orientations so sliding-dominant geometry (e.g. one big
    wall) cannot starve the constraint directions.

    Fixed-shape formulation: bucket normals by dominant signed axis (6 bins), stable
    argsort on (bin, pixel index), then take count/bins entries from each
    bin's segment via dynamic slices. Under-full bins spill into neighboring
    segments (still valid points, slightly unbalanced). Requires a pyramid
    built with normals.
    """
    h, w = level.valid.shape
    npix = h * w
    count = min(count, npix)
    n = level.normal_map.reshape(npix, 3)
    ok = level.valid.reshape(npix)
    axis = jnp.argmax(jnp.abs(n), axis=-1)  # 0..2
    sign = jnp.take_along_axis(n, axis[:, None], axis=-1)[:, 0] < 0
    bin_id = jnp.where(ok, axis + 3 * sign.astype(jnp.int32), bins)  # invalid -> bins
    order = jnp.argsort(bin_id, stable=True)  # segments per bin, pixel order kept
    counts = jnp.bincount(bin_id, length=bins + 1).astype(jnp.int32)
    starts = jnp.concatenate([jnp.zeros(1, jnp.int32), jnp.cumsum(counts)[:-1]])

    per_bin = count // bins
    rem = count - bins * per_bin
    picks = []
    pick_ok = []
    for b in range(bins):
        # The remainder goes to the first `rem` bins (one extra sample
        # each), so the total stays exactly `count` with no duplicated
        # picks (a shared order[:rem] remainder would double-weight bin
        # 0's head samples in the GN system).
        t_b = per_bin + (1 if b < rem else 0)
        if t_b == 0:
            continue
        # Clamp the slice so it stays in range even for segments at the
        # very end; `off` records how far the clamp shifted it left so the
        # validity mask still selects exactly this bin's entries (an
        # unshifted `lane < counts[b]` would keep earlier-segment points
        # and drop the rare bin's own -- precisely the constraint
        # directions this mode exists to preserve).
        start = jnp.minimum(starts[b], npix - t_b)
        off = starts[b] - start
        lane = jnp.arange(t_b)
        picks.append(jax.lax.dynamic_slice_in_dim(order, start, t_b))
        pick_ok.append((lane >= off) & (lane < off + jnp.minimum(counts[b], t_b)))
    idx = jnp.concatenate(picks)
    seg_ok = jnp.concatenate(pick_ok)
    pts = level.vertex_map.reshape(npix, 3)[idx]
    nrm = n[idx]
    ok_out = ok[idx] & seg_ok
    return pts, nrm, ok_out


def sample_depth_points(
    depth: jnp.ndarray,
    intr: camera.Intrinsics,
    count: int,
    min_depth: float = 0.05,
    max_depth: float = 10.0,
):
    """Stride-sample source points DIRECTLY from a depth map.

    The source role of projective ICP only ever touches `count` points per
    level, so materializing a full vertex map first wastes most of the
    pyramid's bandwidth: gather `count` depth values and unproject just
    those. Produces exactly the same points/validity as
    sample_level(build_pyramid(..., with_normals=False)) at the same stride.
    """
    h, w = depth.shape
    npix = h * w
    count = min(count, npix)
    stride = npix // count
    idx = jnp.arange(count) * stride
    # Static strided SLICE (indices are arange * stride): same elements as a
    # gather but without per-row index reads. `idx` is only used
    # for the (cheap, gather-free) pixel-coordinate arithmetic below.
    d = depth.reshape(npix)[: count * stride : stride]
    ok = jnp.isfinite(d) & (d > min_depth) & (d < max_depth)
    d = jnp.where(ok, d, 0.0)
    u = (idx % w).astype(d.dtype)
    v = (idx // w).astype(d.dtype)
    pts = jnp.stack(
        [d * (u - intr.cx) / intr.fx, d * (v - intr.cy) / intr.fy, d], axis=-1
    )
    return pts, ok


def associate_planes_t(
    T, src_pts_t, src_ok, dst_level: PyramidLevel, intr: camera.Intrinsics, cfg: ProjectiveIcpConfig
):
    """LANE-MAJOR projective association at pose T: ONE gather of the
    destination plane table. src_pts_t is (3, P); returns
    (n_t (3, P), d_plane (P,), ok (P,)).

    Single gather of the planar PLANE table [n | d = n . q]: 4 floats per
    correspondence (vs 8 for vertex+normal+valid; gathers are the hot-loop
    bottleneck). Invalid pixels carry n = 0 -> Jacobian rows vanish and
    validity is |n|^2 > 0.5 for free. The point axis stays minor-most
    throughout ((3, P)/(6, P)).
    Measured throughput-neutral vs the (P, 3) formulation (XLA already
    picked good layouts), so this is about explicitness, not speed.
    """
    p = se3.transform_points_t(T, src_pts_t)  # (3, P)
    x, y, z = p[0], p[1], p[2]
    # Same math as camera.project on (P,) lanes.
    z_safe = jnp.where(jnp.abs(z) > 1e-12, z, 1e-12)
    u = intr.fx * x / z_safe + intr.cx
    v = intr.fy * y / z_safe + intr.cy
    inb = camera.in_bounds(u, v, intr) & (z > cfg.min_depth)
    ui = jnp.clip(jnp.round(u).astype(jnp.int32), 0, intr.width - 1)
    vi = jnp.clip(jnp.round(v).astype(jnp.int32), 0, intr.height - 1)

    rows = dst_level.packed[:, vi, ui]  # (4, P)
    n_t = rows[0:3]
    d_plane = rows[3]
    ok = src_ok & inb & (jnp.sum(n_t * n_t, axis=0) > 0.5)
    return n_t, d_plane, ok


def _cross_t(a, b):
    """Cross product of lane-major (3, P) stacks."""
    return jnp.stack(
        [
            a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0],
        ]
    )


def normal_equations_fixed_t(T, src_pts_t, n_t, d_plane, assoc_ok, cfg: ProjectiveIcpConfig):
    """Weight + accumulate the 6x6 GN system against FIXED planes (n, d):
    gather-free, so it can repeat per association (cfg.inner_iters).
    Lane-major: src_pts_t and n_t are (3, P).

    Returns (H (6,6), b (6,), aux (wsse, wsum, ok_count)).
    """
    p = se3.transform_points_t(T, src_pts_t)  # (3, P)
    r = jnp.sum(n_t * p, axis=0) - d_plane  # point-to-plane residual
    # Correspondence gate on the plane distance (the Euclidean gate needs
    # the destination vertex, which the plane table deliberately drops).
    ok = assoc_ok & (jnp.abs(r) < cfg.dist_threshold)
    r = jnp.where(ok, r, 0.0)
    # GNC weight on the plane residual (reference form, align_icp.cpp:116-118).
    l_rt = cfg.gnc_mu / (r * r + cfg.gnc_mu)
    w = l_rt * l_rt * ok.astype(p.dtype)

    J = jnp.concatenate([n_t, _cross_t(p, n_t)], axis=0)  # (6, P), twist [v, w]
    Jw = J * w[None, :]
    # precision=HIGHEST: reduced-precision operands (bf16, or TF32 on the
    # GPU) would bias the normal equations by ~5e-4 relative --
    # millimeters of pose.
    H = jnp.matmul(Jw, J.T, precision=jax.lax.Precision.HIGHEST)  # (6, 6)
    b = jnp.matmul(Jw, r, precision=jax.lax.Precision.HIGHEST)  # (6,)
    aux = (
        jnp.sum(w * r * r).astype(jnp.float32),
        jnp.sum(w).astype(jnp.float32),
        jnp.sum(ok).astype(jnp.int32),
    )
    return H, b, aux


def associate_planes(
    T, src_pts, src_ok, dst_level: PyramidLevel, intr: camera.Intrinsics, cfg: ProjectiveIcpConfig
):
    """Point-major compatibility wrapper over associate_planes_t:
    src_pts (P, 3) -> (n (P, 3), d_plane (P,), ok (P,))."""
    n_t, d_plane, ok = associate_planes_t(
        T, src_pts.T, src_ok, dst_level, intr, cfg
    )
    return n_t.T, d_plane, ok


def normal_equations_fixed(T, src_pts, n, d_plane, assoc_ok, cfg: ProjectiveIcpConfig):
    """Point-major compatibility wrapper over normal_equations_fixed_t."""
    return normal_equations_fixed_t(T, src_pts.T, n.T, d_plane, assoc_ok, cfg)


def build_normal_equations(
    T, src_pts, src_ok, dst_level: PyramidLevel, intr: camera.Intrinsics, cfg: ProjectiveIcpConfig
):
    """Associate + weight + accumulate the 6x6 GN system for one iteration.

    Returns (H (6,6), b (6,), aux (wsse, wsum, ok_count)). Pure reduction
    over sample points -- the unit that multi-chip point sharding psums over
    (parallel/sharded.py). XLA CSEs the duplicated point transform between
    association and the system build.
    """
    n_t, d_plane, ok = associate_planes_t(
        T, src_pts.T, src_ok, dst_level, intr, cfg
    )
    return normal_equations_fixed_t(T, src_pts.T, n_t, d_plane, ok, cfg)


def solve_update(T, H, b, aux, num_samples: int, cfg: ProjectiveIcpConfig):
    """Damped 6x6 solve + left-multiplied SE(3) update from reduced H, b."""
    lam = cfg.damping * jnp.trace(H) + 1e-12
    Hd = H + lam * jnp.eye(6, dtype=H.dtype)
    delta = -jnp.linalg.solve(Hd, b)
    # Guard rank-deficient geometry: keep pose if the solve went non-finite.
    delta = jnp.where(jnp.all(jnp.isfinite(delta)), delta, jnp.zeros_like(delta))
    T_new = se3.compose(se3.exp(delta), T)

    wsse, wsum, ok_count = aux
    rmse = jnp.sqrt(wsse / (wsum + 1e-12)).astype(jnp.float32)
    frac = (ok_count / num_samples).astype(jnp.float32)
    stats = (rmse, frac, ok_count)
    return T_new, stats


def _step(T, src_pts_t, src_ok, dst_level: PyramidLevel, intr: camera.Intrinsics, cfg: ProjectiveIcpConfig):
    """One association round: ONE plane gather at the current pose, then
    cfg.inner_iters Gauss-Newton updates against those fixed planes
    (inner_iters=1 is classic re-associate-every-step projective ICP).
    src_pts_t is LANE-MAJOR (3, P) -- transposed once per level by callers.
    """
    n_t, d_plane, ok = associate_planes_t(T, src_pts_t, src_ok, dst_level, intr, cfg)
    num_samples = src_pts_t.shape[1]

    def inner(_, carry):
        T_c, _ = carry
        H, b, aux = normal_equations_fixed_t(T_c, src_pts_t, n_t, d_plane, ok, cfg)
        return solve_update(T_c, H, b, aux, num_samples, cfg)

    init = (T, (jnp.float32(0.0), jnp.float32(0.0), jnp.int32(0)))
    if cfg.inner_iters <= 1:
        return inner(0, init)
    return jax.lax.fori_loop(0, cfg.inner_iters, inner, init)


@partial(jax.jit, static_argnames=("intrs", "cfg"))
def projective_icp(
    src_levels: Sequence[PyramidLevel],
    dst_levels: Sequence[PyramidLevel],
    intrs: tuple[camera.Intrinsics, ...],
    init_transform: jnp.ndarray | None = None,
    cfg: ProjectiveIcpConfig = ProjectiveIcpConfig(),
) -> ProjectiveIcpResult:
    """Coarse-to-fine registration of src frame onto dst frame.

    `src_levels`/`dst_levels` come from ops.pyramid.build_pyramid (fine ->
    coarse); `cfg.iters` is coarse -> fine. Everything unrolls into one XLA
    program: per level a lax.fori_loop of GN steps over a fixed sample set.
    """
    num_levels = len(intrs)
    assert len(cfg.iters) == num_levels, "one iteration count per level"
    T = se3.identity() if init_transform is None else init_transform

    stats = (jnp.float32(0.0), jnp.float32(0.0), jnp.int32(0))
    for li in range(num_levels - 1, -1, -1):  # coarse -> fine
        level_iters = cfg.iters[num_levels - 1 - li]
        level_samples = max(cfg.samples // (cfg.coarse_sample_divisor**li), cfg.min_samples)
        if cfg.sample_mode == "normal_space":
            src_pts, _, src_ok = sample_level_normal_space(src_levels[li], level_samples)
        else:
            src_pts, _, src_ok = sample_level(src_levels[li], level_samples)
        src_pts_t = src_pts.T  # lane-major for the GN loop, once per level
        dst_level = dst_levels[li]
        intr = intrs[li]

        def body(_, carry, dst_level=dst_level, intr=intr, src_pts_t=src_pts_t, src_ok=src_ok):
            T, _ = carry
            return _step(T, src_pts_t, src_ok, dst_level, intr, cfg)

        T, stats = jax.lax.fori_loop(0, level_iters, body, (T, stats))

    rmse, inlier_frac, matched = stats
    return ProjectiveIcpResult(
        transform=T,
        rmse=rmse,
        inlier_fraction=inlier_frac.astype(jnp.float32),
        num_matched=matched,
    )


@partial(jax.jit, static_argnames=("intrs", "cfg"))
def projective_icp_sampled(
    src_samples,  # tuple per level (fine -> coarse) of (pts (P,3), ok (P,))
    dst_levels: Sequence[PyramidLevel],
    intrs: tuple[camera.Intrinsics, ...],
    init_transform: jnp.ndarray | None = None,
    cfg: ProjectiveIcpConfig = ProjectiveIcpConfig(),
) -> ProjectiveIcpResult:
    """Registration with pre-sampled source points (sample_depth_points):
    skips source pyramid construction entirely -- the fast path used by
    register_depth_pair for stride sampling."""
    num_levels = len(intrs)
    assert len(cfg.iters) == num_levels, "one iteration count per level"
    T = se3.identity() if init_transform is None else init_transform

    stats = (jnp.float32(0.0), jnp.float32(0.0), jnp.int32(0))
    for li in range(num_levels - 1, -1, -1):  # coarse -> fine
        level_iters = cfg.iters[num_levels - 1 - li]
        src_pts, src_ok = src_samples[li]
        src_pts_t = src_pts.T  # lane-major for the GN loop, once per level
        dst_level = dst_levels[li]
        intr = intrs[li]

        def body(_, carry, dst_level=dst_level, intr=intr, src_pts_t=src_pts_t, src_ok=src_ok):
            T, _ = carry
            return _step(T, src_pts_t, src_ok, dst_level, intr, cfg)

        T, stats = jax.lax.fori_loop(0, level_iters, body, (T, stats))

    rmse, inlier_frac, matched = stats
    return ProjectiveIcpResult(
        transform=T,
        rmse=rmse,
        inlier_fraction=inlier_frac.astype(jnp.float32),
        num_matched=matched,
    )


def register_depth_pair(
    src_depth: jnp.ndarray,
    dst_depth: jnp.ndarray,
    intr: camera.Intrinsics,
    cfg: ProjectiveIcpConfig = ProjectiveIcpConfig(),
    init_transform: jnp.ndarray | None = None,
) -> ProjectiveIcpResult:
    """End-to-end single-pair registration: depths in -> SE(3) out.

    The whole pipeline (unproject -> normals -> pyramid -> coarse-to-fine GN)
    traces into one XLA program; vmap over leading axes for batching.
    """
    from realsensetracker_tpu.ops.pyramid import build_pyramid, downsample_depth

    cfg = fit_levels(cfg, *src_depth.shape[-2:])
    num_levels = len(cfg.iters)
    dst_levels, intrs = build_pyramid(
        dst_depth, intr, num_levels, cfg.min_depth, cfg.max_depth
    )
    if cfg.sample_mode == "normal_space":
        # Orientation binning needs source normals: full source pyramid.
        src_levels, _ = build_pyramid(
            src_depth, intr, num_levels, cfg.min_depth, cfg.max_depth,
            with_normals=True,
        )
        return projective_icp(src_levels, dst_levels, tuple(intrs), init_transform, cfg)
    # Fast path: the source role only ever touches cfg.samples points per
    # level -- sample straight from the (downsampled) depth maps and skip
    # source vertex/normal map construction altogether.
    src_depth = src_depth.astype(jnp.float32)
    valid = camera.valid_mask(src_depth, cfg.min_depth, cfg.max_depth)
    d = jnp.where(valid, src_depth, 0.0)
    samples = []
    for li in range(num_levels):
        level_samples = max(cfg.samples // (cfg.coarse_sample_divisor**li), cfg.min_samples)
        samples.append(
            sample_depth_points(d, intrs[li], level_samples, cfg.min_depth, cfg.max_depth)
        )
        d, valid = downsample_depth(d, valid)
    return projective_icp_sampled(
        tuple(samples), dst_levels, tuple(intrs), init_transform, cfg
    )
