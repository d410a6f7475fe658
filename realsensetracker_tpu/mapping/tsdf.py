"""Truncated signed distance function (TSDF) volume on a dense grid.

KinectFusion-style dense fusion as the device-side completion of the
reference's mapping plan: the reference fuses a sparse first-point-wins
voxel point map (rs_replay_app.cpp:76-129) and leaves frame-to-model
tracking in a compiled-out branch (:274-287). A TSDF volume is the
classic dense upgrade -- every depth frame carves free space and refines
the zero-level surface by a weighted running average, and raycasting the
volume renders a SYNTHETIC low-noise depth frame to track against
(tracking/tsdf_tracker.py), which drifts less than either frame-to-frame
or point-map frame-to-model.

Shape of the three operations:

* ``integrate`` -- all V^3 voxel centers project into the depth frame at
  once. The camera coordinates of an axis-aligned grid are AFFINE in the
  grid indices, so they assemble from three broadcast (V,) vectors
  (zero-FLOP rank-3 broadcast add, no (V^3, 3) matmul or coordinate
  tensor needed); the only real cost is ONE (V, V, V) advanced-index
  gather of the depth map plus elementwise updates -- exactly one pass
  over device memory at ~16 bytes/voxel.
* ``raycast`` -- a fixed-trip-count ``lax.fori_loop`` marching all H*W
  rays in lockstep, one nearest-neighbor (H, W) volume gather per step;
  the zero crossing is refined by linear interpolation between the two
  straddling samples. No per-ray control flow, no early exit: every ray
  pays the same fixed step budget, which is what keeps the program one
  static XLA loop.
* ``extract_surface`` -- zero crossings between axis-adjacent voxel
  pairs, linearly interpolated, emitted as a fixed-capacity masked Cloud
  (ops.cloud semantics) for PLY export / downstream registration.

Distances are PROJECTIVE (along the camera z axis), the standard
KinectFusion approximation: sdf = depth(pixel) - z_cam, truncated to
[-trunc, +trunc] and scaled to [-1, 1].
"""

from __future__ import annotations

import math
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from realsensetracker_tpu.geometry import camera, se3
from realsensetracker_tpu.ops import cloud as cloud_mod


class TsdfConfig(NamedTuple):
    """Static volume + raycast configuration (hashable -> jit static arg).

    The default 128^3 x 4 cm grid spans a 5.12 m cube centered on x/y
    with the camera (world origin, looking down +z) near the z=0 face --
    the geometry of a seated/handheld RealSense scan.
    """

    resolution: int = 128  # voxels per axis (V)
    voxel_size: float = 0.04  # meters
    origin: tuple[float, float, float] = (-2.56, -2.56, -0.56)
    trunc: float = 0.12  # truncation band (meters); >= 2-3 voxels
    max_weight: float = 64.0  # running-average cap (bounds update inertia)
    min_depth: float = 0.05
    max_depth: float = 10.0
    max_range: float = 4.5  # raycast march range (meters)
    step_frac: float = 0.5  # march step = step_frac * trunc (< 1: no
    # crossing can be stepped over -- the truncation band is 2*trunc wide)
    raycast_coarse: int = 1  # >1: coarse-to-fine raycast (the tracker's
    # render path); cuts the gather-bound march cost ~coarse^2-fold on
    # the full-budget phase at the cost of sub-coarse-cell structures
    refine_steps: int = 8  # full-res refinement steps when coarse > 1;
    # must cover the seed window (2 pre-steps + the coarse neighborhood's
    # depth spread). On-chip phase probe at coarse=4 (raycast_phases2):
    # 8 renders bit-equal depths to 12 (absdiff 0.0 mm, 99.8% identical
    # valid set) for ~19% less raycast time -- the full-res fine march
    # is the raycast's largest gather bill (~9.5 ms/step at 640x480).
    # The same probe kept coarse=8 OUT of the defaults (valid coverage
    # drops to 97.7%, hits bias 1.6 mm, and it is only ~8% faster: the
    # coarse march is NOT where the time goes) and kept subvoxel_iters=1
    # IN (31% of the raycast but an 11 mm render accuracy swing).
    track_scale: int = 1  # frame-to-model TRACKING resolution divisor
    # (power of two). Read by tracking/tsdf_tracker.py's step math, not
    # by the mapping ops: with track_scale=s the model renders and the
    # ICP runs at (H/s, W/s) -- the raycast's gather bill (the tracked
    # step's dominant cost) drops
    # ~s^2-fold -- while integration still fuses the FULL-resolution
    # frame, so map quality is unchanged. The live frame downsamples
    # with the same validity-aware 2x2 pooling the ICP pyramid uses.
    # Combine with raycast_coarse only while (H/s) % coarse == 0.
    integrate_every: int = 1  # fuse every Nth tracked frame (standard
    # KinectFusion integrate decimation). The full-resolution integrate
    # pass (~47 ms at 128^3 / 640x480) is the dense tracked step's floor
    # once the render is reduced (track_scale); decimating it divides
    # that floor by N. Cadence: the frame counter since the (re)seed --
    # frames 0 (the seed), N, 2N, ... fuse; a due frame whose
    # registration FAILS simply misses its slot (failures never fuse).
    # Pose estimation still runs EVERY frame against the (up to N-1
    # frames stale) render; the fused map is a strict subsample of the
    # N=1 map, so drift grows only through render staleness. NOTE: in
    # the vmapped multi-stream/serving paths the integrate is computed
    # and masked (vmap turns lax.cond into select), so decimation saves
    # nothing there; the win is on the single-stream tracked step and
    # the submap atlas, where the cond genuinely skips the pass.
    integrate_slab: int = 0  # static edge length (voxels) of the
    # frustum-restricted integration sub-grid; 0 = full-volume update.
    # The integrate pass is GATHER-ISSUE-RATE bound (V^3 gathers from the
    # depth image at ~40 M gathers/s on-chip ~= 47 ms at 128^3), so its
    # cost scales with the number of voxels VISITED, not updated. With a
    # slab, each frame computes the world AABB of its observed frustum
    # segment (camera center -> backprojected surface points + trunc
    # margin) on device and updates only a dynamic_slice'd S^3 sub-grid
    # positioned over it -- (V/S)^3-fold fewer gathers. If the AABB does
    # not fit in S^3 (wide scene at full range) the frame falls back to
    # the full-volume pass inside the same program (lax.cond), so the
    # fused result is ALWAYS identical to the full pass: voxels outside
    # the AABB cannot satisfy the update predicate (out of frustum, or
    # farther than trunc behind every observed surface). NOTE: like
    # integrate_every, the win is single-stream only -- under vmap the
    # cond becomes a select and both paths are paid.
    subvoxel_iters: int = 1  # trilinear secant refinements of each ray
    # hit AFTER the march: the march samples the TSDF nearest-neighbor,
    # so its interpolated crossing carries voxel-scale staircase error
    # that warps the rendered surface -- the dominant geometric-term bias
    # in photometric frame-to-model tracking (a synthetic wall slide:
    # 31 mm vs 0.6 mm frame-to-frame). Each iteration re-brackets
    # the hit with two observation-gated TRILINEAR samples (+-0.6 voxel
    # along the ray) and re-interpolates the zero crossing of the
    # continuous field. 0 restores the raw march hit. 1 is the default:
    # it cut the wall-slide drift 31 -> 2.5 mm for 16 extra gathers per
    # hit; extra iterations measured NON-monotonic (the trilinear field
    # is only piecewise linear along the ray, so re-bracketing across a
    # cell kink can oscillate: 9.1 mm at 2 iters, 1.9 at 3).

    @property
    def num_steps(self) -> int:
        # Pure Python math: this runs INSIDE jit traces (fori_loop trip
        # count), where a jnp op would become an abstract tracer.
        step = self.step_frac * self.trunc
        return int(math.ceil((self.max_range - self.min_depth) / step))


def sized_config(resolution: int = 0, voxel_size: float = 0.0,
                 base: TsdfConfig | None = None) -> TsdfConfig:
    """A TsdfConfig resized to ``resolution``/``voxel_size`` (0 keeps the
    base value) while preserving the default layout: x/y centered on the
    camera, the z=0 face at the same fractional inset. Shared by the CLI
    --tsdf-resolution/--tsdf-voxel flags (rs_replay, rs_serve)."""
    base = base or TsdfConfig()
    res = resolution or base.resolution
    vox = voxel_size or base.voxel_size
    extent = res * vox
    z_frac = base.origin[2] / (base.resolution * base.voxel_size)
    return base._replace(
        resolution=res, voxel_size=vox,
        origin=(-extent / 2, -extent / 2, z_frac * extent),
    )


class TsdfVolume(NamedTuple):
    """Device-resident dense TSDF grid.

    ``tsdf`` holds the truncated signed distance in units of
    ``cfg.trunc`` (so [-1, 1]); unobserved voxels stay at +1 with weight
    0, which the raycaster reads as free/unknown space for free.
    ``color``/``color_weight`` are present only on colored volumes
    (init_volume(with_color=True)): RGB in [0, 1] fused by its own
    running average over the near-surface band.
    """

    tsdf: jnp.ndarray  # (V, V, V) float32 in [-1, 1]
    weight: jnp.ndarray  # (V, V, V) float32 >= 0
    color: jnp.ndarray | None = None  # (V, V, V, 3) float32 in [0, 1]
    color_weight: jnp.ndarray | None = None  # (V, V, V) float32 >= 0

    @property
    def resolution(self) -> int:
        return self.tsdf.shape[-1]


def init_volume(cfg: TsdfConfig, with_color: bool = False) -> TsdfVolume:
    v = cfg.resolution
    return TsdfVolume(
        tsdf=jnp.ones((v, v, v), jnp.float32),
        weight=jnp.zeros((v, v, v), jnp.float32),
        color=jnp.zeros((v, v, v, 3), jnp.float32) if with_color else None,
        color_weight=(
            jnp.zeros((v, v, v), jnp.float32) if with_color else None
        ),
    )


def _grid_cam_coords(pose_cam_from_world: jnp.ndarray, cfg: TsdfConfig,
                     start=None, size: int | None = None):
    """Camera-frame coordinates of every voxel center, as three (S, S, S)
    arrays assembled from broadcast (S,) vectors (S = ``size`` or the
    full resolution; ``start`` = traced (3,) int sub-grid offset for the
    frustum-slab path).

    cam = R @ world + t with world[i,j,k] = origin + (idx + 0.5) * vs is
    affine per grid axis: cam_a[i,j,k] = X_a[i] + Y_a[j] + Z_a[k] + t_a
    -- the offset only shifts the per-axis line vectors, so the slab
    path stays affine-in-index (never materialize (S^3, 3) coords).
    """
    v = size if size is not None else cfg.resolution
    R = pose_cam_from_world[:3, :3].astype(jnp.float32)
    t = pose_cam_from_world[:3, 3].astype(jnp.float32)
    o = jnp.asarray(cfg.origin, jnp.float32)
    vs = jnp.float32(cfg.voxel_size)
    # The slab path SLICES the full-resolution line vector instead of
    # recomputing it shifted: o + start*vs + (j+0.5)*vs rounds
    # differently from o + (idx+0.5)*vs in f32 and the last-ulp
    # difference flips boundary voxels across the update predicate --
    # slicing keeps the slab bit-identical to the full pass.
    line = (jnp.arange(cfg.resolution, dtype=jnp.float32) + 0.5) * vs
    # world axis 0 -> x, axis 1 -> y, axis 2 -> z
    if start is None:
        wx = o[0] + line
        wy = o[1] + line
        wz = o[2] + line
    else:
        wx = jax.lax.dynamic_slice(o[0] + line, (start[0],), (v,))
        wy = jax.lax.dynamic_slice(o[1] + line, (start[1],), (v,))
        wz = jax.lax.dynamic_slice(o[2] + line, (start[2],), (v,))

    def axis_coord(a):
        return (
            (R[a, 0] * wx)[:, None, None]
            + (R[a, 1] * wy)[None, :, None]
            + (R[a, 2] * wz)[None, None, :]
            + t[a]
        )

    return axis_coord(0), axis_coord(1), axis_coord(2)


@partial(jax.jit, static_argnames=("intr", "cfg"))
def integrate(
    vol: TsdfVolume,
    depth: jnp.ndarray,
    pose_world_from_cam: jnp.ndarray,
    intr: camera.Intrinsics,
    cfg: TsdfConfig = TsdfConfig(),
    color: jnp.ndarray | None = None,
) -> TsdfVolume:
    """Fuse one depth frame taken at ``pose_world_from_cam`` into the
    volume (weighted running average, KinectFusion eq. 11-13).

    Only voxels with sdf >= -trunc update (in front of or just behind the
    observed surface); voxels occluded deeper than the truncation band
    keep their state, so surfaces seen from the other side later are not
    destroyed.

    ``color`` ((H, W, 3) RGB in [0, 1]) is required iff the volume was
    created with_color: it fuses by its own running average, restricted
    to the near-surface band |sdf| <= trunc (free-space voxels must not
    absorb surface color).
    """
    if (vol.color is not None) != (color is not None):
        raise ValueError(
            "colored volume needs a color frame (and vice versa): "
            f"vol.color={'set' if vol.color is not None else 'None'}, "
            f"color={'set' if color is not None else 'None'}"
        )
    depth = jnp.asarray(depth, jnp.float32)
    pose_cam_from_world = se3.inverse(pose_world_from_cam)
    s = int(cfg.integrate_slab)
    if s <= 0 or s >= cfg.resolution:
        blk = _fuse_block(
            (vol.tsdf, vol.weight, vol.color, vol.color_weight),
            depth, color, pose_cam_from_world, intr, cfg,
        )
        return TsdfVolume(*blk)
    return _integrate_slab(vol, depth, pose_world_from_cam,
                           pose_cam_from_world, intr, cfg, color)


def _fuse_block(block, depth, color, pose_cam_from_world, intr,
                cfg: TsdfConfig, start=None, size: int | None = None):
    """KinectFusion running-average update of one (S, S, S) grid block
    (the full volume when ``start``/``size`` are None). Returns the
    updated (tsdf, weight, color, color_weight) tuple."""
    tsdf_b, weight_b, color_b, cw_b = block
    h, w = depth.shape
    cx_, cy_, cz_ = _grid_cam_coords(pose_cam_from_world, cfg, start, size)

    z_safe = jnp.where(cz_ > 1e-6, cz_, 1e-6)
    u = intr.fx * cx_ / z_safe + intr.cx
    v_ = intr.fy * cy_ / z_safe + intr.cy
    ui = jnp.clip(jnp.round(u).astype(jnp.int32), 0, w - 1)
    vi = jnp.clip(jnp.round(v_).astype(jnp.int32), 0, h - 1)
    inb = (
        (cz_ > cfg.min_depth)
        & (u >= -0.5) & (u < w - 0.5)
        & (v_ >= -0.5) & (v_ < h - 0.5)
    )
    d = depth[vi, ui]  # the ONE (S, S, S) gather
    d_ok = jnp.isfinite(d) & (d > cfg.min_depth) & (d < cfg.max_depth)
    d = jnp.where(d_ok, d, 0.0)

    sdf = d - cz_  # projective signed distance (meters)
    upd = inb & d_ok & (sdf >= -cfg.trunc)
    obs = jnp.minimum(sdf / jnp.float32(cfg.trunc), 1.0)  # [-1, 1]

    m = upd.astype(jnp.float32)
    w_new = weight_b + m
    tsdf_new = jnp.where(
        upd,
        (tsdf_b * weight_b + obs * m) / jnp.maximum(w_new, 1.0),
        tsdf_b,
    )
    new_color, new_cw = color_b, cw_b
    if color_b is not None:
        band = upd & (sdf <= cfg.trunc)  # |sdf| <= trunc with upd's floor
        mc = band.astype(jnp.float32)
        cw_new = cw_b + mc
        rgb = jnp.asarray(color, jnp.float32)[vi, ui]  # (S, S, S, 3)
        new_color = jnp.where(
            band[..., None],
            (color_b * cw_b[..., None] + rgb * mc[..., None])
            / jnp.maximum(cw_new, 1.0)[..., None],
            color_b,
        )
        new_cw = jnp.minimum(cw_new, cfg.max_weight)
    return tsdf_new, jnp.minimum(w_new, cfg.max_weight), new_color, new_cw


def _integrate_slab(vol, depth, pose_world_from_cam, pose_cam_from_world,
                    intr, cfg: TsdfConfig, color):
    """Frustum-restricted integration (TsdfConfig.integrate_slab = S).

    Computes the world AABB of this frame's update support -- the union
    of camera->surface segments extended trunc past the surface, i.e.
    the only region where ``upd`` can hold -- and updates a
    dynamic_slice'd S^3 block positioned over it; falls back to the
    full-volume pass (identical math, same program) when the AABB
    exceeds S voxels on any axis. The AABB margin accounts for ray
    obliquity: a trunc extension in camera z stretches to at most
    trunc * max ||dir||_inf over the image, plus a voxel for the
    nearest-pixel rounding.
    """
    v = cfg.resolution
    s = int(cfg.integrate_slab)
    dir_x, dir_y, dir_z = _ray_dirs(pose_world_from_cam, intr)
    t = pose_world_from_cam[:3, 3].astype(jnp.float32)
    d_ok = (
        jnp.isfinite(depth) & (depth > cfg.min_depth)
        & (depth < cfg.max_depth)
    )
    d = jnp.where(d_ok, depth, 0.0)
    big = jnp.float32(3.0e38)
    # Static obliquity bound from the image corners: ||dir||/z <=
    # sqrt(((max|u-cx|)/fx)^2 + ((max|v-cy|)/fy)^2 + 1).
    mu = max(abs(0.0 - intr.cx), abs(intr.width - 1.0 - intr.cx)) / intr.fx
    mv = max(abs(0.0 - intr.cy), abs(intr.height - 1.0 - intr.cy)) / intr.fy
    margin = (
        cfg.trunc * math.sqrt(mu * mu + mv * mv + 1.0)
        + 2.0 * cfg.voxel_size
    )
    o = jnp.asarray(cfg.origin, jnp.float32)
    inv_vs = jnp.float32(1.0 / cfg.voxel_size)

    starts, fits = [], jnp.bool_(True)
    any_valid = jnp.any(d_ok)
    for a, dir_a in enumerate((dir_x, dir_y, dir_z)):
        pts = t[a] + d * dir_a  # surface endpoints (world axis a)
        lo = jnp.minimum(jnp.min(jnp.where(d_ok, pts, big)), t[a])
        hi = jnp.maximum(jnp.max(jnp.where(d_ok, pts, -big)), t[a])
        i_lo = jnp.floor((lo - margin - o[a]) * inv_vs - 0.5).astype(
            jnp.int32)
        i_hi = jnp.ceil((hi + margin - o[a]) * inv_vs - 0.5).astype(
            jnp.int32)
        i_lo = jnp.clip(i_lo, 0, v - 1)
        i_hi = jnp.clip(i_hi, 0, v - 1)
        fits = fits & (i_hi - i_lo + 1 <= s)
        starts.append(jnp.clip(i_lo, 0, v - s))
    start = jnp.stack(starts)
    fits = fits & any_valid  # no valid depth -> both paths are no-ops;
    # take the full one (its update mask is all-False, nothing to place)

    def slab_path(vol):
        blk = tuple(
            None if arr is None else
            jax.lax.dynamic_slice(
                arr, (start[0], start[1], start[2])
                + (jnp.int32(0),) * (arr.ndim - 3),
                (s, s, s) + arr.shape[3:],
            )
            for arr in (vol.tsdf, vol.weight, vol.color, vol.color_weight)
        )
        new_blk = _fuse_block(blk, depth, color, pose_cam_from_world,
                              intr, cfg, start, s)
        out = tuple(
            None if new is None else jax.lax.dynamic_update_slice(
                arr, new,
                (start[0], start[1], start[2])
                + (jnp.int32(0),) * (arr.ndim - 3),
            )
            for arr, new in zip(
                (vol.tsdf, vol.weight, vol.color, vol.color_weight),
                new_blk,
            )
        )
        return TsdfVolume(*out)

    def full_path(vol):
        return TsdfVolume(*_fuse_block(
            (vol.tsdf, vol.weight, vol.color, vol.color_weight),
            depth, color, pose_cam_from_world, intr, cfg,
        ))

    return jax.lax.cond(fits, slab_path, full_path, vol)


def _ray_dirs(pose_world_from_cam: jnp.ndarray, intr: camera.Intrinsics):
    """World-frame ray direction per unit z-depth for every pixel:
    R @ [(u-cx)/fx, (v-cy)/fy, 1], as three (H, W) planes."""
    h, w = int(intr.height), int(intr.width)
    R = pose_world_from_cam[:3, :3].astype(jnp.float32)
    uu = (jnp.arange(w, dtype=jnp.float32) - intr.cx) / intr.fx  # (W,)
    vv = (jnp.arange(h, dtype=jnp.float32) - intr.cy) / intr.fy  # (H,)
    return tuple(
        R[a, 0] * uu[None, :] + R[a, 1] * vv[:, None] + R[a, 2]
        for a in range(3)
    )


UNOBSERVED = 2.0  # sentinel for weight==0 cells in the fused march field:
# observed TSDF values live in [-1, 1], so "< 1.5" tests observation with
# ZERO extra gathers (the march/trilinear paths are gather-issue-rate
# bound; a separate weight gather doubled their cost on-chip)


def march_field(vol) -> jnp.ndarray:
    """FLAT (V^3,) observation-fused march field: clip(tsdf, -1, 1) where
    observed, UNOBSERVED elsewhere. One elementwise pass per render, after
    which every march/refinement sample is a single 1-D gather (linearized
    index) instead of two 3-D gathers -- measured 1147 ms for the exact
    640x480 raycast with the 2-gather 3-D form (~40 M gathers/s) vs the
    ~170 M rows/s the 2-D plane-table gather sustains on the same chip."""
    return jnp.where(
        vol.weight > 0, jnp.clip(vol.tsdf, -1.0, 1.0),
        jnp.float32(UNOBSERVED),
    ).reshape(-1)


def _march(field, t, dirs, z_start, n_steps: int, cfg: TsdfConfig):
    """Lockstep ray march from per-pixel depth ``z_start`` for ``n_steps``
    fixed steps; nearest-neighbor sampling of the fused march field,
    interpolated zero crossing. Returns (z_hit, found), both shaped like
    ``dirs[0]``."""
    dir_x, dir_y, dir_z = dirs
    v = cfg.resolution
    o = jnp.asarray(cfg.origin, jnp.float32)
    inv_vs = jnp.float32(1.0 / cfg.voxel_size)
    step = jnp.float32(cfg.step_frac * cfg.trunc)
    z_start = jnp.broadcast_to(
        jnp.asarray(z_start, jnp.float32), dir_x.shape
    )

    def sample(z):
        """Nearest-neighbor field value at ray depth z; outside -> +1."""
        px = t[0] + z * dir_x
        py = t[1] + z * dir_y
        pz = t[2] + z * dir_z
        gx = (px - o[0]) * inv_vs - 0.5
        gy = (py - o[1]) * inv_vs - 0.5
        gz = (pz - o[2]) * inv_vs - 0.5
        ix = jnp.clip(jnp.round(gx).astype(jnp.int32), 0, v - 1)
        iy = jnp.clip(jnp.round(gy).astype(jnp.int32), 0, v - 1)
        iz = jnp.clip(jnp.round(gz).astype(jnp.int32), 0, v - 1)
        inside = (
            (gx > -0.5) & (gx < v - 0.5)
            & (gy > -0.5) & (gy < v - 0.5)
            & (gz > -0.5) & (gz < v - 0.5)
        )
        raw = field[(ix * v + iy) * v + iz]  # THE per-step gather
        seen = inside & (raw < 1.5)
        return jnp.where(inside, raw, 1.0), seen

    def body(k, carry):
        prev_val, prev_seen, z_hit, found = carry
        z = z_start + (k.astype(jnp.float32) + 1.0) * step
        val, seen = sample(z)
        # First crossing from observed-positive to observed-negative.
        cross = (~found) & prev_seen & seen & (prev_val > 0) & (val <= 0)
        denom = prev_val - val
        frac = prev_val / jnp.where(jnp.abs(denom) > 1e-12, denom, 1e-12)
        z_cross = (z - step) + step * jnp.clip(frac, 0.0, 1.0)
        z_hit = jnp.where(cross, z_cross, z_hit)
        return val, seen, z_hit, found | cross

    val0, seen0 = sample(z_start)
    init = (
        val0,
        seen0,
        jnp.zeros(dir_x.shape, jnp.float32),
        jnp.zeros(dir_x.shape, bool),
    )
    _, _, z_hit, found = jax.lax.fori_loop(0, n_steps, body, init)
    return z_hit, found


def _trilinear_tsdf(field, px, py, pz, cfg: TsdfConfig):
    """Observation-gated trilinear TSDF sample at world points, reading
    the fused march field (ONE 1-D gather per corner).

    Weighted average over the observed (field < 1.5) corners of the
    surrounding cell, normalized by the observed weight mass -- the same
    gating render_model_rgbd uses for fused color, so unobserved corners
    (+1 free-space placeholders) never bias a sample near the frustum
    edge. Returns (value, valid); valid requires ANY observed mass.
    (A stricter half-mass gate was measured WORSE: it refuses exactly
    the frustum-boundary ring, leaving those pixels on the biased
    nearest-neighbor march hit -- two −9 mm border rows of an otherwise
    exact wall render dragged a photometric frame-to-model solve by
    8.5 mm/frame.)"""
    o = jnp.asarray(cfg.origin, jnp.float32)
    inv_vs = jnp.float32(1.0 / cfg.voxel_size)
    v = cfg.resolution
    gx = (px - o[0]) * inv_vs - 0.5
    gy = (py - o[1]) * inv_vs - 0.5
    gz = (pz - o[2]) * inv_vs - 0.5
    x0 = jnp.clip(jnp.floor(gx).astype(jnp.int32), 0, v - 2)
    y0 = jnp.clip(jnp.floor(gy).astype(jnp.int32), 0, v - 2)
    z0 = jnp.clip(jnp.floor(gz).astype(jnp.int32), 0, v - 2)
    fx = jnp.clip(gx - x0, 0.0, 1.0)
    fy = jnp.clip(gy - y0, 0.0, 1.0)
    fz = jnp.clip(gz - z0, 0.0, 1.0)
    acc = jnp.zeros(jnp.shape(gx), jnp.float32)
    w_acc = jnp.zeros(jnp.shape(gx), jnp.float32)
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                w = (
                    (fx if dx else 1.0 - fx)
                    * (fy if dy else 1.0 - fy)
                    * (fz if dz else 1.0 - fz)
                )
                lin = ((x0 + dx) * v + y0 + dy) * v + z0 + dz
                cval = field[lin]
                w = w * (cval < 1.5)
                acc = acc + w * cval
                w_acc = w_acc + w
    val = acc / jnp.maximum(w_acc, 1e-12)
    return val, w_acc > 1e-6


def _refine_subvoxel(field, t, dirs, z_hit, found, cfg: TsdfConfig):
    """cfg.subvoxel_iters trilinear secant refinements of march hits.

    Each pass samples the continuous (trilinear) TSDF at z +- delta along
    the ray and moves the hit to the linear zero crossing of that
    bracket, clamped to the bracket; where either sample is invalid or
    the bracket is degenerate the hit is left as the march found it.
    Kills the nearest-neighbor staircase bias."""
    if cfg.subvoxel_iters <= 0:
        return z_hit
    dir_x, dir_y, dir_z = dirs
    delta = jnp.float32(0.6 * cfg.voxel_size)
    z = z_hit
    for _ in range(cfg.subvoxel_iters):
        zm, zp = z - delta, z + delta
        pm, okm = _trilinear_tsdf(
            field, t[0] + zm * dir_x, t[1] + zm * dir_y, t[2] + zm * dir_z,
            cfg,
        )
        pp, okp = _trilinear_tsdf(
            field, t[0] + zp * dir_x, t[1] + zp * dir_y, t[2] + zp * dir_z,
            cfg,
        )
        denom = pm - pp  # > 0 through a front-facing crossing
        ok = okm & okp & (denom > 1e-6)
        frac = jnp.clip(pm / jnp.where(ok, denom, 1.0), 0.0, 1.0)
        z = jnp.where(ok, zm + 2.0 * delta * frac, z)
    return jnp.where(found, z, z_hit)


@partial(jax.jit, static_argnames=("intr", "cfg"))
def raycast(
    vol: TsdfVolume,
    pose_world_from_cam: jnp.ndarray,
    intr: camera.Intrinsics,
    cfg: TsdfConfig = TsdfConfig(),
) -> jnp.ndarray:
    """Render a synthetic (H, W) depth map of the zero-level surface as
    seen from ``pose_world_from_cam``.

    Marches all rays in z-lockstep (projective: the sample at "distance"
    z is the camera-frame point z * [(u-cx)/fx, (v-cy)/fy, 1], matching
    integrate's projective sdf), sampling the volume nearest-neighbor
    once per step; the first +/- crossing is refined by linear
    interpolation of the straddling tsdf samples. Pixels whose ray never
    crosses inside the observed (weight > 0) region return 0 (invalid --
    the convention camera.valid_mask / build_pyramid already treat as
    missing depth).
    """
    t = pose_world_from_cam[:3, 3].astype(jnp.float32)
    dirs = _ray_dirs(pose_world_from_cam, intr)
    field = march_field(vol)
    z_hit, found = _march(
        field, t, dirs, jnp.float32(cfg.min_depth), cfg.num_steps, cfg
    )
    z_hit = _refine_subvoxel(field, t, dirs, z_hit, found, cfg)
    return jnp.where(found, z_hit, 0.0)


@partial(jax.jit, static_argnames=("intr", "cfg", "coarse", "refine_steps"))
def raycast_coarse_to_fine(
    vol: TsdfVolume,
    pose_world_from_cam: jnp.ndarray,
    intr: camera.Intrinsics,
    cfg: TsdfConfig = TsdfConfig(),
    coarse: int = 4,
    refine_steps: int = 8,
) -> jnp.ndarray:
    """Two-phase raycast: full march at 1/coarse resolution, then a short
    full-resolution refinement march seeded near the coarse surface.

    The full-resolution lockstep march is gather-issue-rate bound
    (H * W * num_steps volume gathers); this cuts the gather count by
    ~num_steps / (num_steps/coarse^2 + refine_steps) -- ~5.7x at 640x480
    with the defaults -- at the cost of missing structures thinner than a
    coarse cell. Each full-res ray starts 2 steps before the MINIMUM
    coarse hit in its 3x3 coarse neighborhood (min, not bilinear: depth
    at silhouettes is a step function, and interpolating across one
    would seed the refinement behind the foreground surface). Pixels
    with no coarse hit anywhere in the neighborhood are invalid.

    Requires intr.height/width divisible by ``coarse``.
    """
    h, w = int(intr.height), int(intr.width)
    if h % coarse or w % coarse:
        raise ValueError(f"{h}x{w} not divisible by coarse={coarse}")
    t = pose_world_from_cam[:3, 3].astype(jnp.float32)
    step = jnp.float32(cfg.step_frac * cfg.trunc)

    intr_c = camera.Intrinsics(
        fx=intr.fx / coarse,
        fy=intr.fy / coarse,
        cx=(intr.cx + 0.5) / coarse - 0.5,
        cy=(intr.cy + 0.5) / coarse - 0.5,
        width=w // coarse,
        height=h // coarse,
    )
    dirs_c = _ray_dirs(pose_world_from_cam, intr_c)
    field = march_field(vol)
    z_c, found_c = _march(
        field, t, dirs_c, jnp.float32(cfg.min_depth), cfg.num_steps, cfg
    )

    # 3x3 neighborhood MIN of coarse hits (misses -> +inf).
    z_inf = jnp.where(found_c, z_c, jnp.float32(jnp.inf))
    pooled = jax.lax.reduce_window(
        z_inf, jnp.float32(jnp.inf), jax.lax.min,
        (3, 3), (1, 1), "SAME",
    )
    seeded = jnp.isfinite(pooled)

    up = jnp.repeat(jnp.repeat(pooled, coarse, axis=0), coarse, axis=1)
    seeded_up = jnp.repeat(
        jnp.repeat(seeded, coarse, axis=0), coarse, axis=1
    )
    z_start = jnp.maximum(
        jnp.where(seeded_up, up, jnp.float32(cfg.min_depth)) - 2.0 * step,
        jnp.float32(cfg.min_depth),
    )

    dirs = _ray_dirs(pose_world_from_cam, intr)
    z_hit, found = _march(field, t, dirs, z_start, refine_steps, cfg)
    z_hit = _refine_subvoxel(field, t, dirs, z_hit, found & seeded_up, cfg)
    return jnp.where(found & seeded_up, z_hit, 0.0)


def render_model_depth(
    vol: TsdfVolume,
    pose_world_from_cam: jnp.ndarray,
    intr: camera.Intrinsics,
    cfg: TsdfConfig = TsdfConfig(),
) -> jnp.ndarray:
    """Config-dispatched model render: exact full march, or coarse-to-fine
    when cfg.raycast_coarse > 1 (the tracker's hot path)."""
    if cfg.raycast_coarse > 1:
        return raycast_coarse_to_fine(
            vol, pose_world_from_cam, intr, cfg,
            coarse=cfg.raycast_coarse, refine_steps=cfg.refine_steps,
        )
    return raycast(vol, pose_world_from_cam, intr, cfg)


@partial(jax.jit, static_argnames=("intr", "cfg"))
def render_model_rgbd(
    vol: TsdfVolume,
    pose_world_from_cam: jnp.ndarray,
    intr: camera.Intrinsics,
    cfg: TsdfConfig = TsdfConfig(),
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """(depth, gray) render of a COLORED volume: the depth raycast plus
    one fused-color lookup at every hit point.

    Color samples trilinearly over the 8 surrounding voxels, gated by
    color observation (color_weight > 0) so unobserved corners never
    darken a surface edge; gray is BT.601 luma in [0, 1] (the unit the
    photometric aligner is calibrated in, align/rgbd.py). Miss pixels
    return (0, 0). This is the model half of photometric frame-to-model
    tracking (TsdfTracker photometric=...): the reference never got its
    photometric cost compiling (photometric_cost.hpp), let alone against
    a fused dense model.
    """
    if vol.color is None:
        raise ValueError("render_model_rgbd needs a with_color volume")
    depth = render_model_depth(vol, pose_world_from_cam, intr, cfg)
    t = pose_world_from_cam[:3, 3].astype(jnp.float32)
    dir_x, dir_y, dir_z = _ray_dirs(pose_world_from_cam, intr)
    o = jnp.asarray(cfg.origin, jnp.float32)
    inv_vs = jnp.float32(1.0 / cfg.voxel_size)
    v = cfg.resolution
    gx = (t[0] + depth * dir_x - o[0]) * inv_vs - 0.5
    gy = (t[1] + depth * dir_y - o[1]) * inv_vs - 0.5
    gz = (t[2] + depth * dir_z - o[2]) * inv_vs - 0.5
    x0 = jnp.clip(jnp.floor(gx).astype(jnp.int32), 0, v - 2)
    y0 = jnp.clip(jnp.floor(gy).astype(jnp.int32), 0, v - 2)
    z0 = jnp.clip(jnp.floor(gz).astype(jnp.int32), 0, v - 2)
    fx = jnp.clip(gx - x0, 0.0, 1.0)
    fy = jnp.clip(gy - y0, 0.0, 1.0)
    fz = jnp.clip(gz - z0, 0.0, 1.0)
    rgb_acc = jnp.zeros(depth.shape + (3,), jnp.float32)
    w_acc = jnp.zeros(depth.shape, jnp.float32)
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                w = (
                    (fx if dx else 1.0 - fx)
                    * (fy if dy else 1.0 - fy)
                    * (fz if dz else 1.0 - fz)
                )
                ix, iy, iz = x0 + dx, y0 + dy, z0 + dz
                w = w * (vol.color_weight[ix, iy, iz] > 0)
                rgb_acc = rgb_acc + w[..., None] * vol.color[ix, iy, iz]
                w_acc = w_acc + w
    rgb = rgb_acc / jnp.maximum(w_acc, 1e-12)[..., None]
    luma = jnp.asarray([0.299, 0.587, 0.114], jnp.float32)
    gray = jnp.sum(rgb * luma, axis=-1)
    valid = (depth > 0) & (w_acc > 0)
    return depth, jnp.where(valid, gray, 0.0)


def _masked_gradient(t: jnp.ndarray, seen: jnp.ndarray) -> jnp.ndarray:
    """(V, V, V, 3) TSDF gradient that never reads UNSEEN voxels.

    Central differences where both axis neighbors are observed, one-sided
    toward the observed side otherwise, zero when isolated. Plain
    jnp.gradient would smear the +1 unknown-space placeholder into every
    observed-region boundary (measured: 12% of a wall patch's normals
    tilted up to 50 degrees, all on the frustum edge ring)."""
    def shift(a, ax, d, fill):
        pad = [(0, 0)] * 3
        pad[ax] = (1, 0) if d > 0 else (0, 1)
        sl = [slice(None)] * 3
        sl[ax] = slice(None, -1) if d > 0 else slice(1, None)
        return jnp.pad(a[tuple(sl)], pad, constant_values=fill)

    axes = []
    for ax in range(3):
        tf, sf = shift(t, ax, -1, 1.0), shift(seen, ax, -1, False)
        tb, sb = shift(t, ax, +1, 1.0), shift(seen, ax, +1, False)
        g = jnp.where(
            sf & sb,
            0.5 * (tf - tb),
            jnp.where(sf, tf - t, jnp.where(sb, t - tb, 0.0)),
        )
        axes.append(g)
    return jnp.stack(axes, axis=-1)


def _surface_candidates(vol: TsdfVolume, cfg: TsdfConfig,
                        with_normals: bool = False):
    """Zero crossings between axis-adjacent voxel pairs: (pts (M, 3),
    mask (M,), colors (M, 3) | None, normals (M, 3) | None),
    M = 3 * V^2 * (V-1). Normals are the normalized TSDF gradient
    (central differences, lerped to the crossing) -- they point from the
    surface into free space, the same orientation integrate carves."""
    v = cfg.resolution
    o = jnp.asarray(cfg.origin, jnp.float32)
    vs = jnp.float32(cfg.voxel_size)
    base = (jnp.arange(v, dtype=jnp.float32) + 0.5) * vs
    xs = (o[0] + base)[:, None, None]
    ys = (o[1] + base)[None, :, None]
    zs = (o[2] + base)[None, None, :]
    centers = (
        jnp.broadcast_to(xs, (v, v, v)),
        jnp.broadcast_to(ys, (v, v, v)),
        jnp.broadcast_to(zs, (v, v, v)),
    )
    seen = vol.weight > 0
    grad = _masked_gradient(vol.tsdf, seen) if with_normals else None

    pts_parts, mask_parts, col_parts, nrm_parts = [], [], [], []
    for axis in range(3):
        sl_a = [slice(None)] * 3
        sl_b = [slice(None)] * 3
        sl_a[axis] = slice(0, v - 1)
        sl_b[axis] = slice(1, v)
        a = vol.tsdf[tuple(sl_a)]
        b = vol.tsdf[tuple(sl_b)]
        ok = (
            seen[tuple(sl_a)]
            & seen[tuple(sl_b)]
            & (jnp.sign(a) != jnp.sign(b))
        )
        denom = a - b
        frac = jnp.clip(
            a / jnp.where(jnp.abs(denom) > 1e-12, denom, 1e-12), 0.0, 1.0
        )
        coords = [c[tuple(sl_a)] for c in centers]
        coords[axis] = coords[axis] + frac * vs
        pts_parts.append(
            jnp.stack([c.reshape(-1) for c in coords], axis=-1)
        )
        mask_parts.append(ok.reshape(-1))
        if vol.color is not None:
            ca = vol.color[tuple(sl_a)]
            cb = vol.color[tuple(sl_b)]
            col = ca + frac[..., None] * (cb - ca)
            col_parts.append(col.reshape(-1, 3))
        if with_normals:
            ga = grad[tuple(sl_a)]
            gb = grad[tuple(sl_b)]
            g = ga + frac[..., None] * (gb - ga)
            g = g / jnp.maximum(
                jnp.linalg.norm(g, axis=-1, keepdims=True), 1e-12
            )
            nrm_parts.append(g.reshape(-1, 3))

    pts = jnp.concatenate(pts_parts, axis=0)
    mask = jnp.concatenate(mask_parts, axis=0)
    cols = (
        jnp.concatenate(col_parts, axis=0) if vol.color is not None else None
    )
    nrms = jnp.concatenate(nrm_parts, axis=0) if with_normals else None
    return pts, mask, cols, nrms


def _compact_to_capacity(pts, mask, capacity: int) -> cloud_mod.Cloud:
    # subsample_to_capacity requires valid rows compacted to the front
    # (ops/cloud.py contract); crossings are scattered across the grid, so
    # compact via a stable sort on the mask (original order preserved).
    order = jnp.argsort(~mask, stable=True)
    c = cloud_mod.Cloud(points=pts[order], mask=mask[order])
    return cloud_mod.subsample_to_capacity(c, capacity)


@partial(jax.jit, static_argnames=("cfg", "capacity"))
def extract_surface(
    vol: TsdfVolume, cfg: TsdfConfig = TsdfConfig(), capacity: int = 65536
) -> cloud_mod.Cloud:
    """Zero-level surface as a fixed-capacity masked point cloud.

    For each of the 3 grid axes, adjacent-voxel pairs whose observed tsdf
    values straddle zero emit one linearly-interpolated point. Purely
    dense elementwise work + one capacity reduction; the analog of the
    reference's ExtractPointCloud (rs_replay_app.cpp:113-122) on the
    dense map.
    """
    pts, mask, _, _ = _surface_candidates(vol, cfg)
    return _compact_to_capacity(pts, mask, capacity)


@partial(jax.jit, static_argnames=("cfg", "capacity"))
def extract_surface_colored(
    vol: TsdfVolume, cfg: TsdfConfig = TsdfConfig(), capacity: int = 65536
) -> tuple[cloud_mod.Cloud, jnp.ndarray]:
    """Colored zero-level surface: (Cloud, colors (capacity, 3) in [0, 1]).

    Crossing colors interpolate between the two straddling voxels' fused
    RGB (same lerp fraction as the point). Colors ride through the
    capacity reduction as extra row columns so the point<->color pairing
    survives the compaction reorder. Requires a with_color volume.
    """
    pts, mask, cols, _ = _surface_candidates(vol, cfg)
    if cols is None:
        raise ValueError("extract_surface_colored needs a colored volume "
                         "(init_volume(with_color=True))")
    joint = _compact_to_capacity(
        jnp.concatenate([pts, cols], axis=-1), mask, capacity
    )
    return (
        cloud_mod.Cloud(points=joint.points[:, :3], mask=joint.mask),
        joint.points[:, 3:],
    )


@partial(jax.jit, static_argnames=("cfg", "capacity"))
def extract_surface_oriented(
    vol: TsdfVolume, cfg: TsdfConfig = TsdfConfig(), capacity: int = 65536
) -> tuple[cloud_mod.Cloud, jnp.ndarray]:
    """Oriented zero-level surface: (Cloud, normals (capacity, 3)).

    Normals are the normalized TSDF gradient at each crossing (central
    differences lerped between the straddling voxels), pointing into
    free space / toward the cameras that observed the surface -- ready
    for point-to-plane registration or normal-space sampling without a
    PCA pass. Normals ride the capacity compaction as extra row columns
    so the point<->normal pairing survives the reorder."""
    pts, mask, _, nrms = _surface_candidates(vol, cfg, with_normals=True)
    joint = _compact_to_capacity(
        jnp.concatenate([pts, nrms], axis=-1), mask, capacity
    )
    return (
        cloud_mod.Cloud(points=joint.points[:, :3], mask=joint.mask),
        joint.points[:, 3:],
    )
