"""Multi-stream tracking: S concurrent frame streams in one compiled step.

BASELINE config 5 ("8 concurrent streams at 30 FPS with live pose output"):
per-stream state (pose + reference pyramid) lives on device as batched
arrays; one jitted step registers every stream's new frame against its own
reference and updates pose/reference only where tracking succeeded.
Streams shard over the mesh data axis for multi-chip scaling.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from realsensetracker_tpu.align import projective, rgbd
from realsensetracker_tpu.geometry import camera, se3
from realsensetracker_tpu.ops.pyramid import build_pyramid, depth_to_meters


class StreamState(NamedTuple):
    poses: jnp.ndarray  # (S, 4, 4) world_from_camera
    ref_levels: tuple  # pytree of batched PyramidLevels (reference frames)
    initialized: jnp.ndarray  # (S,) bool
    frame_count: jnp.ndarray  # (S,) int32


class StreamStepResult(NamedTuple):
    poses: jnp.ndarray  # (S, 4, 4)
    success: jnp.ndarray  # (S,)
    rmse: jnp.ndarray  # (S,)
    inlier_fraction: jnp.ndarray  # (S,)


def _build_levels(depths, intr, cfg):
    cfg = projective.fit_levels(cfg, *depths.shape[-2:])

    def one(d):
        levels, intrs = build_pyramid(d, intr, len(cfg.iters), cfg.min_depth, cfg.max_depth)
        return tuple(levels), tuple(intrs)

    batched = jax.vmap(lambda d: one(d)[0])(depths)
    _, intrs = one(depths[0])
    return batched, intrs


@partial(jax.jit, static_argnames=("intr", "cfg", "num_streams", "depth_scale"))
def init_streams(
    first_depths: jnp.ndarray,  # (S, H, W)
    intr: camera.Intrinsics,
    cfg: projective.ProjectiveIcpConfig = projective.ProjectiveIcpConfig(),
    num_streams: int | None = None,
    depth_scale: float = 1.0,  # meters per unit for INTEGER frames
    # (raw u16 uploads at half the bytes; ops/pyramid.depth_to_meters)
) -> StreamState:
    first_depths = depth_to_meters(first_depths, depth_scale)
    s = first_depths.shape[0] if num_streams is None else num_streams
    levels, _ = _build_levels(first_depths, intr, cfg)
    return StreamState(
        poses=jnp.broadcast_to(jnp.eye(4, dtype=jnp.float32), (s, 4, 4)),
        ref_levels=levels,
        initialized=jnp.ones((s,), bool),
        frame_count=jnp.ones((s,), jnp.int32),
    )


def _register_all(ref_levels, depths, intr, cfg, min_inlier_fraction):
    """Build new pyramids and register every slot against its reference.

    Shared by the always-on and the masked steps so a parity-relevant fix
    (precision annotation, success-gate change) lands in both. Returns
    (new_levels, icp_result, ok) with ok = finite transform & inlier gate.
    """
    # fit_levels here is for projective_icp below (which must see the
    # resolution-fitted schedule); _build_levels re-fits internally for
    # its other callers -- idempotent, same min-extent rule, keep both
    # fits in sync if fit_levels ever grows parameters.
    cfg = projective.fit_levels(cfg, *depths.shape[-2:])
    new_levels, intrs = _build_levels(depths, intr, cfg)

    def one(ref_lv, new_lv):
        return projective.projective_icp(new_lv, ref_lv, tuple(intrs), cfg=cfg)

    res = jax.vmap(one)(ref_levels, new_levels)
    finite = jnp.all(jnp.isfinite(res.transform), axis=(-2, -1))
    ok = finite & (res.inlier_fraction >= min_inlier_fraction)
    return new_levels, res, ok


def _step_impl(state, depths, intr, cfg, min_inlier_fraction):
    new_levels, res, success = _register_all(
        state.ref_levels, depths, intr, cfg, min_inlier_fraction
    )

    # Orthonormalized accumulation (batched 3x3 SVD; see se3.orthonormalize).
    new_pose = se3.orthonormalize(se3.compose(state.poses, res.transform))
    poses = jnp.where(success[:, None, None], new_pose, state.poses)
    # Failure semantics (ref rs_replay_app.cpp:266-273): keep the old
    # reference frame and pose where registration failed.
    ref_levels = jax.tree.map(
        lambda new, old: jnp.where(
            success.reshape((-1,) + (1,) * (new.ndim - 1)), new, old
        ),
        new_levels,
        state.ref_levels,
    )
    new_state = StreamState(
        poses=poses,
        ref_levels=ref_levels,
        initialized=state.initialized,
        frame_count=state.frame_count + 1,
    )
    return new_state, StreamStepResult(
        poses=poses,
        success=success,
        rmse=res.rmse,
        inlier_fraction=res.inlier_fraction,
    )


@partial(jax.jit, static_argnames=("intr", "cfg", "min_inlier_fraction",
                                   "depth_scale"))
def step_streams(
    state: StreamState,
    depths: jnp.ndarray,  # (S, H, W) one new frame per stream
    intr: camera.Intrinsics,
    cfg: projective.ProjectiveIcpConfig = projective.ProjectiveIcpConfig(),
    min_inlier_fraction: float = 0.2,
    depth_scale: float = 1.0,
) -> tuple[StreamState, StreamStepResult]:
    """Advance every stream by one frame in a single compiled step."""
    depths = depth_to_meters(depths, depth_scale)
    return _step_impl(state, depths, intr, cfg, min_inlier_fraction)


@partial(jax.jit, static_argnames=("intr", "cfg", "min_inlier_fraction",
                                   "depth_scale"))
def step_streams_window(
    state: StreamState,
    depths: jnp.ndarray,  # (S, W, H, Wd): W new frames per stream
    intr: camera.Intrinsics,
    cfg: projective.ProjectiveIcpConfig = projective.ProjectiveIcpConfig(),
    min_inlier_fraction: float = 0.2,
    depth_scale: float = 1.0,
) -> tuple[StreamState, StreamStepResult]:
    """Advance every stream by W frames in ONE compiled dispatch.

    lax.scan of the multi-stream step over the window axis: S x W frames
    per dispatch, amortizing the per-dispatch host cost over the
    whole window (the same lever as rs_replay --window for single-stream
    SLAM). Per-frame results come back batched as (S, W, ...); the final
    state equals W sequential step_streams calls exactly (parity-tested).
    Sharding over the mesh data axis passes through the scan unchanged.
    """
    depths = depth_to_meters(depths, depth_scale)

    def body(st, frame_batch):  # (S, H, Wd) frames, one per stream
        return _step_impl(st, frame_batch, intr, cfg, min_inlier_fraction)

    state2, seq = jax.lax.scan(body, state, jnp.moveaxis(depths, 1, 0))
    return state2, StreamStepResult(
        *(jnp.moveaxis(x, 0, 1) for x in seq)
    )


@partial(jax.jit, static_argnames=("intr", "cfg", "num_streams"))
def blank_streams(
    intr: camera.Intrinsics,
    cfg: projective.ProjectiveIcpConfig = projective.ProjectiveIcpConfig(),
    num_streams: int = 8,
) -> StreamState:
    """Uninitialized S-slot state (all slots inactive, identity poses).

    Slots come alive one at a time through `step_streams_masked`'s `seed`
    mask — the serving executor (api/batching.py) allocates one slot per
    session as sessions connect, instead of requiring every stream's first
    frame up front like `init_streams`.
    """
    depths = jnp.zeros(
        (num_streams, int(intr.height), int(intr.width)), jnp.float32
    )
    levels, _ = _build_levels(depths, intr, cfg)
    return StreamState(
        poses=jnp.broadcast_to(
            jnp.eye(4, dtype=jnp.float32), (num_streams, 4, 4)
        ),
        ref_levels=levels,
        initialized=jnp.zeros((num_streams,), bool),
        frame_count=jnp.zeros((num_streams,), jnp.int32),
    )


# Packed per-slot stats row of step_streams_masked: pose (16) | relative
# (16) | success | rmse | inlier_fraction. One (S, 35) array = ONE host
# materialization per dispatch.
MASKED_STATS_WIDTH = 35


@partial(jax.jit, static_argnames=("intr", "cfg", "min_inlier_fraction",
                                   "depth_scale"))
def step_streams_masked(
    state: StreamState,
    depths: jnp.ndarray,  # (S, H, W) one new frame per slot
    active: jnp.ndarray,  # (S,) bool: slots with a request this round
    seed: jnp.ndarray,  # (S,) bool: active slot's FIRST frame (re)seeds it
    intr: camera.Intrinsics,
    cfg: projective.ProjectiveIcpConfig = projective.ProjectiveIcpConfig(),
    min_inlier_fraction: float = 0.2,
    depth_scale: float = 1.0,
) -> tuple[StreamState, jnp.ndarray]:
    """Advance only the `active` slots; `seed` slots take the new frame as
    their reference at identity pose (the per-stream init branch,
    rs_replay_app.cpp:236-240). Inactive slots' pose/reference/frame_count
    are untouched, so one compiled program serves ANY subset of sessions —
    the serving-side dynamic batcher dispatches whatever requests are
    pending as one step instead of one device program per session.

    Returns (new_state, stats (S, 35)); see MASKED_STATS_WIDTH for the row
    layout. Rows of inactive slots report their held pose with
    success=False.
    """
    return _masked_impl(state, depth_to_meters(depths, depth_scale),
                        active, seed, intr, cfg, min_inlier_fraction)


def _masked_finish(state, transform, ok, active, seed, rmse, inlier,
                   extra_cols, new_refs, old_refs):
    """Shared masking/pose/stats core of every masked step (depth-only and
    RGB-D, single and windowed) -- a semantics fix here lands in all of
    them. `new_refs`/`old_refs` are parallel tuples of reference pytrees
    swapped where the slot seeded or tracked successfully; `extra_cols`
    are (S,) columns packed between rmse and inlier (RGB-D photo_rmse).

    Returns (poses, initialized, frame_count, swapped_refs, stats).
    """
    seeding = active & seed
    tracking = active & ~seed
    success = tracking & ok

    eye = jnp.eye(4, dtype=jnp.float32)
    new_pose = se3.orthonormalize(se3.compose(state.poses, transform))
    poses = jnp.where(success[:, None, None], new_pose, state.poses)
    poses = jnp.where(seeding[:, None, None], eye, poses)
    take_new = success | seeding

    def sel(new, old):
        return jnp.where(
            take_new.reshape((-1,) + (1,) * (new.ndim - 1)), new, old
        )

    refs = tuple(
        jax.tree.map(sel, new, old) for new, old in zip(new_refs, old_refs)
    )
    f32 = jnp.float32
    relative = jnp.where(seeding[:, None, None], eye, transform)
    report_ok = success | seeding
    cols = [jnp.where(seeding, f32(0.0), rmse.astype(f32))]
    cols += [jnp.where(seeding, f32(0.0), e.astype(f32))
             for e in extra_cols]
    cols.append(jnp.where(seeding, f32(1.0), inlier.astype(f32)))
    s = poses.shape[0]
    stats = jnp.concatenate(
        [
            poses.reshape(s, 16).astype(f32),
            relative.reshape(s, 16).astype(f32),
            report_ok[:, None].astype(f32),
        ]
        + [c[:, None] for c in cols],
        axis=1,
    )
    return (
        poses,
        state.initialized | seeding,
        state.frame_count + active.astype(jnp.int32),
        refs,
        stats,
    )


def _masked_impl(state, depths, active, seed, intr, cfg,
                 min_inlier_fraction):
    new_levels, res, ok = _register_all(
        state.ref_levels, depths, intr, cfg, min_inlier_fraction
    )
    poses, initialized, count, (ref_levels,), stats = _masked_finish(
        state, res.transform, ok, active, seed, res.rmse,
        res.inlier_fraction, [], (new_levels,), (state.ref_levels,),
    )
    return StreamState(poses, ref_levels, initialized, count), stats


@partial(jax.jit, static_argnames=("intr", "cfg", "min_inlier_fraction",
                                   "depth_scale"))
def step_streams_masked_window(
    state: StreamState,
    depths: jnp.ndarray,  # (S, W, H, Wd): up to W new frames per slot
    active: jnp.ndarray,  # (S, W) bool: which window rows carry a frame
    seed: jnp.ndarray,  # (S, W) bool: row is that slot's FIRST frame
    intr: camera.Intrinsics,
    cfg: projective.ProjectiveIcpConfig = projective.ProjectiveIcpConfig(),
    min_inlier_fraction: float = 0.2,
    depth_scale: float = 1.0,
) -> tuple[StreamState, jnp.ndarray]:
    """Masked multi-stream step over a W-frame window in ONE dispatch.

    lax.scan of `step_streams_masked` over the window axis: the two
    dispatch-amortization levers compose — frames batch ACROSS sessions
    (slot axis) and ALONG time (window axis), so S near-line sessions
    posting W-frame batches cost ~1 device dispatch per S*W frames.
    Sessions with fewer than W pending frames pad with active=False rows
    (those scan steps leave their slot bit-identical), which keeps the
    compiled program unique per (S, W) shape.

    Returns (new_state, stats (S, W, 35)) — per-frame rows in window
    order, identical to W sequential step_streams_masked calls.
    """
    depths = depth_to_meters(depths, depth_scale)

    def body(st, xs):
        d, a, sd = xs
        return _masked_impl(st, d, a, sd, intr, cfg, min_inlier_fraction)

    state2, stats_seq = jax.lax.scan(
        body,
        state,
        (
            jnp.moveaxis(depths, 1, 0),
            jnp.moveaxis(active, 1, 0),
            jnp.moveaxis(seed, 1, 0),
        ),
    )
    return state2, jnp.moveaxis(stats_seq, 0, 1)


class RgbdStreamState(NamedTuple):
    """Per-slot RGB-D state: reference plane tables + intensity pyramids."""

    poses: jnp.ndarray  # (S, 4, 4) world_from_camera
    ref_levels: tuple  # batched plane-table pyramid (reference frames)
    ref_grays: tuple  # batched intensity pyramid (reference frames)
    initialized: jnp.ndarray  # (S,) bool
    frame_count: jnp.ndarray  # (S,) int32


def _build_rgbd_targets(depths, grays, intr, cfg):
    def one(d, g):
        lv, gl, _ = rgbd.build_rgbd_target(d, g, intr, cfg)
        return tuple(lv), tuple(gl)

    levels, gray_levels = jax.vmap(one)(depths, grays)
    _, _, intrs = rgbd.build_rgbd_target(depths[0], grays[0], intr, cfg)
    return levels, gray_levels, tuple(intrs)


@partial(jax.jit, static_argnames=("intr", "cfg", "num_streams"))
def blank_streams_rgbd(
    intr: camera.Intrinsics,
    cfg: rgbd.RgbdIcpConfig = rgbd.RgbdIcpConfig(),
    num_streams: int = 8,
) -> RgbdStreamState:
    """Uninitialized S-slot RGB-D state (see blank_streams)."""
    z = jnp.zeros(
        (num_streams, int(intr.height), int(intr.width)), jnp.float32
    )
    levels, gray_levels, _ = _build_rgbd_targets(z, z, intr, cfg)
    return RgbdStreamState(
        poses=jnp.broadcast_to(
            jnp.eye(4, dtype=jnp.float32), (num_streams, 4, 4)
        ),
        ref_levels=levels,
        ref_grays=gray_levels,
        initialized=jnp.zeros((num_streams,), bool),
        frame_count=jnp.zeros((num_streams,), jnp.int32),
    )


# RGB-D stats row: pose (16) | relative (16) | success | rmse | photo_rmse
# | inlier_fraction.
MASKED_RGBD_STATS_WIDTH = 36


@partial(jax.jit, static_argnames=("intr", "cfg", "min_inlier_fraction",
                                   "depth_scale"))
def step_streams_masked_rgbd(
    state: RgbdStreamState,
    depths: jnp.ndarray,  # (S, H, W)
    grays: jnp.ndarray,  # (S, H, W) [0, 1] intensities
    active: jnp.ndarray,  # (S,) bool
    seed: jnp.ndarray,  # (S,) bool
    intr: camera.Intrinsics,
    cfg: rgbd.RgbdIcpConfig = rgbd.RgbdIcpConfig(),
    min_inlier_fraction: float = 0.2,
    depth_scale: float = 1.0,
) -> tuple[RgbdStreamState, jnp.ndarray]:
    """RGB-D variant of `step_streams_masked`: each active slot registers
    its new frame against its reference with the JOINT point-to-plane +
    photometric objective (align/rgbd.py), pinning the in-plane motion
    depth-only projective ICP cannot observe on geometry-degenerate scenes.

    Returns (new_state, stats (S, 36)); see MASKED_RGBD_STATS_WIDTH.
    """
    return _masked_rgbd_impl(state, depth_to_meters(depths, depth_scale),
                             grays, active, seed, intr, cfg,
                             min_inlier_fraction)


def _masked_rgbd_impl(state, depths, grays, active, seed, intr, cfg,
                      min_inlier_fraction):
    cfg = projective.fit_levels(cfg, *depths.shape[-2:])
    new_levels, new_grays, intrs = _build_rgbd_targets(
        depths, grays, intr, cfg
    )

    def one(ref_lv, ref_g, d, g):
        samples = rgbd.sample_rgbd_source(d, g, intrs, cfg)
        return rgbd.rgbd_icp_sampled(samples, ref_lv, ref_g, intrs, None, cfg)

    res = jax.vmap(one)(state.ref_levels, state.ref_grays, depths, grays)
    finite = jnp.all(jnp.isfinite(res.transform), axis=(-2, -1))
    ok = finite & (res.inlier_fraction >= min_inlier_fraction)
    poses, initialized, count, refs, stats = _masked_finish(
        state, res.transform, ok, active, seed, res.rmse,
        res.inlier_fraction, [res.photo_rmse],
        (new_levels, new_grays), (state.ref_levels, state.ref_grays),
    )
    ref_levels, ref_grays = refs
    return (
        RgbdStreamState(poses, ref_levels, ref_grays, initialized, count),
        stats,
    )


@partial(jax.jit, static_argnames=("intr", "cfg", "min_inlier_fraction",
                                   "depth_scale"))
def step_streams_masked_rgbd_window(
    state: RgbdStreamState,
    depths: jnp.ndarray,  # (S, W, H, Wd)
    grays: jnp.ndarray,  # (S, W, H, Wd)
    active: jnp.ndarray,  # (S, W) bool
    seed: jnp.ndarray,  # (S, W) bool
    intr: camera.Intrinsics,
    cfg: rgbd.RgbdIcpConfig = rgbd.RgbdIcpConfig(),
    min_inlier_fraction: float = 0.2,
    depth_scale: float = 1.0,
) -> tuple[RgbdStreamState, jnp.ndarray]:
    """RGB-D variant of `step_streams_masked_window` (one scanned dispatch
    for S slots x W frames). Returns (new_state, stats (S, W, 36))."""
    depths = depth_to_meters(depths, depth_scale)

    def body(st, xs):
        d, g, a, sd = xs
        return _masked_rgbd_impl(st, d, g, a, sd, intr, cfg,
                                 min_inlier_fraction)

    state2, stats_seq = jax.lax.scan(
        body,
        state,
        tuple(jnp.moveaxis(x, 1, 0) for x in (depths, grays, active, seed)),
    )
    return state2, jnp.moveaxis(stats_seq, 0, 1)


def shard_streams(state, mesh, data_axis: str = "data"):
    """Shard per-stream state (StreamState, RgbdStreamState, or
    TsdfStreamState) over the mesh's data axis."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    def put(x):
        return jax.device_put(
            x, NamedSharding(mesh, P(data_axis, *([None] * (x.ndim - 1))))
        )

    return jax.tree.map(put, state)


# --- dense (TSDF frame-to-model) streams -----------------------------------


class TsdfStreamState(NamedTuple):
    """S concurrent KinectFusion trackers as batched device state: each
    slot carries its own dense volume ((S, V, V, V) tsdf/weight planes)
    and pose. Device memory is S * 2 * V^3 * 4 bytes (128 MB at S=8,
    V=128) -- the slot axis shards over the mesh data axis
    (shard_streams), which also splits the volumes."""

    poses: jnp.ndarray  # (S, 4, 4) world_from_camera
    volume: object  # mapping.tsdf.TsdfVolume with (S, V, V, V) planes
    initialized: jnp.ndarray  # (S,) bool (seeded at least once)
    frame_count: jnp.ndarray  # (S,) int32


@partial(jax.jit, static_argnames=("intr", "vol_cfg", "depth_scale"))
def init_tsdf_streams(
    first_depths: jnp.ndarray,  # (S, H, W)
    intr: camera.Intrinsics,
    vol_cfg=None,
    depth_scale: float = 1.0,
):
    """Seed S dense streams: each slot's volume integrates its first
    frame at identity."""
    from realsensetracker_tpu.mapping import tsdf as tsdf_mod

    first_depths = depth_to_meters(first_depths, depth_scale)
    vol_cfg = vol_cfg or tsdf_mod.TsdfConfig()

    def seed(d):
        v = tsdf_mod.init_volume(vol_cfg)
        return tsdf_mod.integrate(v, d, se3.identity(), intr, vol_cfg)

    s = first_depths.shape[0]
    return TsdfStreamState(
        poses=jnp.broadcast_to(jnp.eye(4, dtype=jnp.float32), (s, 4, 4)),
        volume=jax.vmap(seed)(first_depths),
        initialized=jnp.ones((s,), bool),
        frame_count=jnp.ones((s,), jnp.int32),
    )


def _tsdf_streams_impl(state, depths, intr, vol_cfg, icp_cfg,
                       min_inlier_fraction):
    from realsensetracker_tpu.tracking.tsdf_tracker import _tsdf_step_math

    # Frustum-slab integration is forced OFF under vmap: the slab's
    # lax.cond becomes a select that computes BOTH the slab and the
    # full pass per slot (strictly slower), and its fused result is
    # bit-identical to the full pass by construction.
    if getattr(vol_cfg, "integrate_slab", 0):
        vol_cfg = vol_cfg._replace(integrate_slab=0)

    # integrate_every cadence keyed on the per-slot frame counter (the
    # same phase as TsdfTracker's counter from a fresh seed: both read 1
    # at the first tracked frame). Under vmap the cond is a select, so
    # decimation saves no compute here -- this only keeps the fused-map
    # SEMANTICS identical to the single-stream tracker.
    n_every = int(getattr(vol_cfg, "integrate_every", 1))
    fuses = (
        state.frame_count % n_every == 0 if n_every > 1
        else jnp.ones(state.poses.shape[0], bool)
    )

    def one(vol, d, pose, fd):
        return _tsdf_step_math(
            vol, d, pose, None, jnp.bool_(True), intr=intr,
            vol_cfg=vol_cfg, icp_cfg=icp_cfg,
            min_inlier_fraction=min_inlier_fraction, fuse=fd,
        )

    out = jax.vmap(one)(state.volume, depths, state.poses, fuses)
    new_state = TsdfStreamState(
        poses=out.pose,
        volume=out.vol,
        initialized=state.initialized,
        frame_count=state.frame_count + 1,
    )
    return new_state, StreamStepResult(
        poses=out.pose,
        success=out.stats[:, 2] > 0.5,
        rmse=out.stats[:, 0],
        inlier_fraction=out.stats[:, 1],
    )


@partial(jax.jit, static_argnames=(
    "intr", "vol_cfg", "icp_cfg", "min_inlier_fraction", "depth_scale"))
def step_tsdf_streams(
    state: TsdfStreamState,
    depths: jnp.ndarray,  # (S, H, W) one new frame per stream
    intr: camera.Intrinsics,
    vol_cfg=None,
    icp_cfg: projective.ProjectiveIcpConfig = projective.ProjectiveIcpConfig(),
    min_inlier_fraction: float = 0.2,
    depth_scale: float = 1.0,
) -> tuple[TsdfStreamState, StreamStepResult]:
    """Advance S dense frame-to-model trackers one frame in ONE compiled
    step (vmapped raycast -> register -> gated integrate; under vmap the
    failure-gate cond becomes a select, so integration cost is paid per
    slot regardless -- batch semantics, same results as per-slot
    tracking)."""
    from realsensetracker_tpu.mapping import tsdf as tsdf_mod

    vol_cfg = vol_cfg or tsdf_mod.TsdfConfig()
    return _tsdf_streams_impl(
        state, depth_to_meters(depths, depth_scale), intr, vol_cfg,
        icp_cfg, min_inlier_fraction,
    )


@partial(jax.jit, static_argnames=(
    "intr", "vol_cfg", "icp_cfg", "min_inlier_fraction", "depth_scale"))
def step_tsdf_streams_window(
    state: TsdfStreamState,
    depths: jnp.ndarray,  # (S, W, H, Wd): W new frames per stream
    intr: camera.Intrinsics,
    vol_cfg=None,
    icp_cfg: projective.ProjectiveIcpConfig = projective.ProjectiveIcpConfig(),
    min_inlier_fraction: float = 0.2,
    depth_scale: float = 1.0,
) -> tuple[TsdfStreamState, StreamStepResult]:
    """Advance S dense streams by W frames in ONE dispatch (lax.scan of
    step_tsdf_streams over the window axis; S volumes ride the carry)."""
    from realsensetracker_tpu.mapping import tsdf as tsdf_mod

    vol_cfg = vol_cfg or tsdf_mod.TsdfConfig()
    depths = depth_to_meters(depths, depth_scale)

    def body(st, frame_batch):
        return _tsdf_streams_impl(
            st, frame_batch, intr, vol_cfg, icp_cfg, min_inlier_fraction
        )

    state2, seq = jax.lax.scan(body, state, jnp.moveaxis(depths, 1, 0))
    return state2, StreamStepResult(*(jnp.moveaxis(x, 0, 1) for x in seq))


@partial(jax.jit, static_argnames=("intr", "vol_cfg", "num_streams"))
def blank_tsdf_streams(
    intr: camera.Intrinsics,
    vol_cfg=None,
    num_streams: int = 8,
) -> TsdfStreamState:
    """Uninitialized S-slot dense state (empty volumes, identity poses);
    slots come alive through step_tsdf_streams_masked's seed mask (the
    serving executor's allocation pattern, api/batching.py)."""
    from realsensetracker_tpu.mapping import tsdf as tsdf_mod

    vol_cfg = vol_cfg or tsdf_mod.TsdfConfig()
    empty = tsdf_mod.init_volume(vol_cfg)
    s = num_streams
    return TsdfStreamState(
        poses=jnp.broadcast_to(jnp.eye(4, dtype=jnp.float32), (s, 4, 4)),
        volume=jax.tree.map(
            lambda x: jnp.broadcast_to(x, (s,) + x.shape), empty
        ),
        initialized=jnp.zeros((s,), bool),
        frame_count=jnp.zeros((s,), jnp.int32),
    )


def _tsdf_masked_impl(state, depths, active, seed, intr, vol_cfg, icp_cfg,
                      min_inlier_fraction):
    from realsensetracker_tpu.mapping import tsdf as tsdf_mod

    # Frustum-slab integration off under vmap (see _tsdf_streams_impl).
    if getattr(vol_cfg, "integrate_slab", 0):
        vol_cfg = vol_cfg._replace(integrate_slab=0)

    eye = jnp.eye(4, dtype=jnp.float32)
    empty = tsdf_mod.init_volume(vol_cfg)
    n_every = int(getattr(vol_cfg, "integrate_every", 1))
    fuses = (
        state.frame_count % n_every == 0 if n_every > 1
        else jnp.ones(state.poses.shape[0], bool)
    )

    def one(vol, d, pose, act, sd, fd):
        # A seeding slot restarts from an EMPTY volume at identity; its
        # registration (against the empty render) fails by construction
        # and is discarded by _masked_finish's seeding branch, so seed +
        # track share ONE raycast/register/integrate program.
        base_vol = jax.tree.map(
            lambda e, v: jnp.where(sd, e, v), empty, vol
        )
        base_pose = jnp.where(sd, eye, pose)
        # Registration honors TsdfConfig.track_scale exactly like the
        # single-stream step (tracking/tsdf_tracker._tsdf_step_math):
        # render + ICP at the reduced resolution, full-res integration.
        from realsensetracker_tpu.tracking.tsdf_tracker import _track_views

        t_d, t_intr = _track_views(
            d, intr, int(getattr(vol_cfg, "track_scale", 1))
        )
        render = tsdf_mod.render_model_depth(base_vol, base_pose, t_intr,
                                             vol_cfg)
        res = projective.register_depth_pair(t_d, render, t_intr, icp_cfg)
        ok = (
            jnp.all(jnp.isfinite(res.transform))
            & (res.inlier_fraction >= min_inlier_fraction)
        )
        pose_cand = jnp.where(
            sd, eye, se3.orthonormalize(se3.compose(pose, res.transform))
        )
        # Integrate unconditionally (vmap turns cond into select anyway);
        # _masked_finish keeps the OLD volume wherever the slot neither
        # seeded nor tracked. integrate_every decimation: a tracked slot
        # whose fuse cadence is not due keeps base_vol (seeding slots
        # always fuse -- their empty volume needs the first surface).
        vol_new = tsdf_mod.integrate(base_vol, d, pose_cand, intr, vol_cfg)
        keep_new = sd | fd
        vol_new = jax.tree.map(
            lambda a, b: jnp.where(keep_new, a, b), vol_new, base_vol
        )
        safe_t = jnp.where(jnp.isfinite(res.transform), res.transform, eye)
        return vol_new, safe_t, ok, res.rmse, res.inlier_fraction

    vol_new, transform, ok, rmse, inlier = jax.vmap(one)(
        state.volume, depths, state.poses, active, seed, fuses
    )
    poses, initialized, count, (volume,), stats = _masked_finish(
        state, transform, ok, active, seed, rmse, inlier, [],
        (vol_new,), (state.volume,),
    )
    return TsdfStreamState(poses, volume, initialized, count), stats


@partial(jax.jit, static_argnames=(
    "intr", "vol_cfg", "icp_cfg", "min_inlier_fraction", "depth_scale"))
def step_tsdf_streams_masked(
    state: TsdfStreamState,
    depths: jnp.ndarray,  # (S, H, W) one new frame per slot
    active: jnp.ndarray,  # (S,) bool: slots with a request this round
    seed: jnp.ndarray,  # (S,) bool: active slot's FIRST frame (re)seeds it
    intr: camera.Intrinsics,
    vol_cfg=None,
    icp_cfg: projective.ProjectiveIcpConfig = projective.ProjectiveIcpConfig(),
    min_inlier_fraction: float = 0.2,
    depth_scale: float = 1.0,
) -> tuple[TsdfStreamState, jnp.ndarray]:
    """Masked dense (KinectFusion) multi-stream step: active slots
    raycast their own volume, register, and integrate at the new pose;
    seed slots restart from an empty volume at identity; inactive slots
    stay bit-identical. Returns (state, stats (S, 35)) with the
    step_streams_masked row layout (MASKED_STATS_WIDTH)."""
    from realsensetracker_tpu.mapping import tsdf as tsdf_mod

    vol_cfg = vol_cfg or tsdf_mod.TsdfConfig()
    return _tsdf_masked_impl(
        state, depth_to_meters(depths, depth_scale), active, seed, intr,
        vol_cfg, icp_cfg, min_inlier_fraction,
    )


@partial(jax.jit, static_argnames=(
    "intr", "vol_cfg", "icp_cfg", "min_inlier_fraction", "depth_scale"))
def step_tsdf_streams_masked_window(
    state: TsdfStreamState,
    depths: jnp.ndarray,  # (S, W, H, Wd)
    active: jnp.ndarray,  # (S, W) bool
    seed: jnp.ndarray,  # (S, W) bool
    intr: camera.Intrinsics,
    vol_cfg=None,
    icp_cfg: projective.ProjectiveIcpConfig = projective.ProjectiveIcpConfig(),
    min_inlier_fraction: float = 0.2,
    depth_scale: float = 1.0,
) -> tuple[TsdfStreamState, jnp.ndarray]:
    """Masked dense multi-stream step over a W-frame window in ONE
    dispatch (lax.scan; S volumes ride the carry). Returns
    (state, stats (S, W, 35)) identical to W sequential masked steps."""
    from realsensetracker_tpu.mapping import tsdf as tsdf_mod

    vol_cfg = vol_cfg or tsdf_mod.TsdfConfig()
    depths = depth_to_meters(depths, depth_scale)

    def body(st, xs):
        d, a, sd = xs
        return _tsdf_masked_impl(
            st, d, a, sd, intr, vol_cfg, icp_cfg, min_inlier_fraction
        )

    state2, stats_seq = jax.lax.scan(
        body,
        state,
        (
            jnp.moveaxis(depths, 1, 0),
            jnp.moveaxis(active, 1, 0),
            jnp.moveaxis(seed, 1, 0),
        ),
    )
    return state2, jnp.moveaxis(stats_seq, 0, 1)
