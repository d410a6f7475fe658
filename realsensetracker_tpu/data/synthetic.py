"""Synthetic depth rendering: hardware-free data source.

Device-side analog of the reference's RandomSource (data_source.hpp:22-41) --
its only camera-free backend -- but geometrically consistent: an analytic
raycast of a sphere/plane scene, so frames rendered from two poses admit an
exact known relative transform. Used by tests and the benchmark; real data
comes from data/tum.py and data/recorded.py.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from realsensetracker_tpu.geometry import camera, se3

_INF = 1e30


class Scene(NamedTuple):
    sphere_centers: jnp.ndarray  # (S, 3) world
    sphere_radii: jnp.ndarray  # (S,)
    sphere_albedo: jnp.ndarray | None = None  # (S, 3) base colors in [0, 1]
    floor_y: float = 1.2
    wall_z: float = 4.0


def default_scene(num_spheres: int = 12, seed: int = 0) -> Scene:
    key = jax.random.PRNGKey(seed)
    k1, k2, k3 = jax.random.split(key, 3)
    centers = jax.random.uniform(
        k1,
        (num_spheres, 3),
        dtype=jnp.float32,
        minval=jnp.array([-1.5, -0.8, 1.0], jnp.float32),
        maxval=jnp.array([1.5, 1.0, 3.5], jnp.float32),
    )
    radii = jax.random.uniform(k2, (num_spheres,), dtype=jnp.float32, minval=0.15, maxval=0.45)
    albedo = jax.random.uniform(
        k3, (num_spheres, 3), dtype=jnp.float32, minval=0.25, maxval=0.95
    )
    return Scene(sphere_centers=centers, sphere_radii=radii, sphere_albedo=albedo)


def _trace(intr: camera.Intrinsics, T_wc: jnp.ndarray, scene: Scene):
    """Raycast the scene: per-pixel hit parameter and surface identity.

    Returns (t_best (H,W) with _INF misses, sid (H,W) int32 surface id
    [0..S-1 spheres, S floor, S+1 wall, S+2 miss], o (3,) ray origin,
    w (H,W,3) world ray directions with z-depth parameterization).
    """
    u = jnp.arange(intr.width, dtype=jnp.float32)
    v = jnp.arange(intr.height, dtype=jnp.float32)
    uu, vv = jnp.meshgrid(u, v)
    d_cam = jnp.stack(
        [(uu - intr.cx) / intr.fx, (vv - intr.cy) / intr.fy, jnp.ones_like(uu)], axis=-1
    )  # (H, W, 3), z = 1 so ray parameter t == z-depth
    R = se3.rotation(T_wc)
    o = se3.translation(T_wc)
    # precision=HIGHEST: reduced-precision operands (bf16, TF32) would
    # bend rays by ~5e-4 relative, breaking the exact-geometry guarantee tests rely on.
    w = jnp.matmul(d_cam, R.T, precision=jax.lax.Precision.HIGHEST)

    # Spheres.
    oc = o - scene.sphere_centers  # (S, 3)
    a = jnp.sum(w * w, axis=-1)[..., None]  # (H, W, 1)
    # precision=HIGHEST: |oc| ~ O(100), so default bf16 operand rounding
    # would perturb ray-sphere intersections by millimeters.
    b = 2.0 * jnp.einsum("hwi,si->hws", w, oc, precision=jax.lax.Precision.HIGHEST)
    c = jnp.sum(oc * oc, axis=-1) - scene.sphere_radii**2  # (S,)
    disc = b * b - 4.0 * a * c
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    t_s = (-b - sq) / (2.0 * a)
    t_s = jnp.where((disc > 0) & (t_s > 1e-3), t_s, _INF)  # (H, W, S)

    # Floor plane y = floor_y (normal -y up; hit from above).
    t_f = (scene.floor_y - o[1]) / jnp.where(jnp.abs(w[..., 1]) > 1e-9, w[..., 1], 1e-9)
    t_f = jnp.where(t_f > 1e-3, t_f, _INF)

    # Back wall z = wall_z.
    t_w = (scene.wall_z - o[2]) / jnp.where(jnp.abs(w[..., 2]) > 1e-9, w[..., 2], 1e-9)
    t_w = jnp.where(t_w > 1e-3, t_w, _INF)

    t_all = jnp.concatenate([t_s, t_f[..., None], t_w[..., None]], axis=-1)
    sid = jnp.argmin(t_all, axis=-1).astype(jnp.int32)
    t_best = jnp.min(t_all, axis=-1)
    num_surf = t_all.shape[-1]
    sid = jnp.where(t_best < _INF, sid, num_surf)
    return t_best, sid, o, w


def render_depth(intr: camera.Intrinsics, T_wc: jnp.ndarray, scene: Scene) -> jnp.ndarray:
    """Z-depth image of the scene from camera pose T_wc (camera->world)."""
    t_best, _, _, _ = _trace(intr, T_wc, scene)
    return jnp.where(t_best < _INF, t_best, 0.0)


_LIGHT_DIR = jnp.asarray([0.40824829, -0.81649658, -0.40824829], jnp.float32)
_FLOOR_ALBEDO = jnp.asarray([0.55, 0.50, 0.40], jnp.float32)
_WALL_ALBEDO = jnp.asarray([0.45, 0.50, 0.60], jnp.float32)


def _default_albedo(num_spheres: int) -> jnp.ndarray:
    """Deterministic distinct sphere colors (golden-angle hue walk)."""
    i = jnp.arange(num_spheres, dtype=jnp.float32)
    h = (i * 0.61803398875) % 1.0
    r = 0.5 + 0.45 * jnp.cos(2 * jnp.pi * h)
    g = 0.5 + 0.45 * jnp.cos(2 * jnp.pi * (h + 1.0 / 3.0))
    b = 0.5 + 0.45 * jnp.cos(2 * jnp.pi * (h + 2.0 / 3.0))
    return jnp.stack([r, g, b], axis=-1)


def render_rgbd(
    intr: camera.Intrinsics, T_wc: jnp.ndarray, scene: Scene
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Render (depth (H,W), color (H,W,3) in [0,1]) from camera pose T_wc.

    Shading is strictly WORLD-anchored (albedo x smooth world-space texture
    x Lambert against a fixed world light), so a surface point renders the
    same color from every viewpoint -- the photometric-consistency property
    direct RGB-D alignment (align/photometric.py, align/rgbd.py) relies on.
    Stands in for the reference's color stream + texcoord lookup
    (rs_driver.cpp:33-103) in this camera-free environment.
    """
    t_best, sid, o, w = _trace(intr, T_wc, scene)
    hit = t_best < _INF
    t = jnp.where(hit, t_best, 1.0)
    x = o + t[..., None] * w  # (H, W, 3) world hit points

    s_count = scene.sphere_centers.shape[0]
    albedo_s = scene.sphere_albedo
    if albedo_s is None:
        albedo_s = _default_albedo(s_count)
    # Albedo table indexed by surface id (misses -> black).
    table = jnp.concatenate(
        [albedo_s, _FLOOR_ALBEDO[None], _WALL_ALBEDO[None],
         jnp.zeros((1, 3), jnp.float32)], axis=0
    )
    base = table[jnp.clip(sid, 0, s_count + 2)]  # (H, W, 3)

    # Surface normals: spheres from center offset, planes constant.
    centers = jnp.concatenate(
        [scene.sphere_centers, jnp.zeros((3, 3), jnp.float32)], axis=0
    )
    c_hit = centers[jnp.clip(sid, 0, s_count + 2)]
    n_sph = x - c_hit
    n_sph = n_sph / jnp.maximum(
        jnp.linalg.norm(n_sph, axis=-1, keepdims=True), 1e-9
    )
    n = jnp.where(
        (sid < s_count)[..., None], n_sph,
        jnp.where(
            (sid == s_count)[..., None],
            jnp.asarray([0.0, -1.0, 0.0], jnp.float32),
            jnp.asarray([0.0, 0.0, -1.0], jnp.float32),
        ),
    )
    shade = 0.35 + 0.65 * jnp.clip(-jnp.sum(n * _LIGHT_DIR, axis=-1), 0.0, 1.0)

    # Smooth world-space texture: dense non-zero image gradient everywhere
    # (what the photometric Jacobian needs), view-independent by design.
    tex = (
        0.70
        + 0.18 * jnp.sin(9.0 * x[..., 0]) * jnp.cos(7.0 * x[..., 1])
        + 0.12 * jnp.sin(5.0 * x[..., 2] + 2.0 * x[..., 0])
    )
    rgb = jnp.clip(base * (shade * tex)[..., None], 0.0, 1.0)
    rgb = jnp.where(hit[..., None], rgb, 0.0)
    depth = jnp.where(hit, t_best, 0.0)
    return depth, rgb


def intensity_from_rgb(rgb: jnp.ndarray) -> jnp.ndarray:
    """Luma graylevel in [0,1] from an (..., 3) color image (BT.601)."""
    w = jnp.asarray([0.299, 0.587, 0.114], rgb.dtype)
    return jnp.sum(rgb * w, axis=-1)


def render_pair(
    intr: camera.Intrinsics,
    motion_twist: jnp.ndarray,
    scene: Scene | None = None,
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Render (depth0, depth1, T_rel): frame1's camera displaced by the twist.

    T_rel maps camera-1 coordinates into camera-0 coordinates, i.e. it is the
    transform a src=frame1 -> dst=frame0 registration should estimate.
    """
    if scene is None:
        scene = default_scene()
    T_wc0 = se3.identity()
    T_c0_c1 = se3.exp(motion_twist)
    T_wc1 = se3.compose(T_wc0, T_c0_c1)
    depth0 = render_depth(intr, T_wc0, scene)
    depth1 = render_depth(intr, T_wc1, scene)
    return depth0, depth1, T_c0_c1


def _random_walk_poses(num_frames: int, seed: int, step_scale: float) -> jnp.ndarray:
    """Shared pose generator: the depth-only and RGB-D trajectory renderers
    MUST produce identical poses for the same seed (record_synthetic_clip
    relies on it), so the walk lives in exactly one place."""
    key = jax.random.PRNGKey(seed)
    twists = step_scale * jax.random.normal(key, (num_frames - 1, 6), dtype=jnp.float32)
    twists = twists.at[:, 3:].multiply(0.5)  # damp rotations vs translations
    return poses_from_twists(twists)


def poses_from_twists(twists: jnp.ndarray) -> jnp.ndarray:
    """Integrate per-step twists (F-1, 6) into world poses (F, 4, 4) from
    identity -- for scripted trajectories (loops, aggressive segments)."""
    poses = [se3.identity()]
    for i in range(twists.shape[0]):
        poses.append(se3.compose(poses[-1], se3.exp(twists[i])))
    return jnp.stack(poses)


def render_trajectory(
    intr: camera.Intrinsics,
    num_frames: int,
    scene: Scene | None = None,
    seed: int = 0,
    step_scale: float = 0.02,
    poses: jnp.ndarray | None = None,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Render a smooth random-walk trajectory (or a scripted `poses` one).

    Returns (depths (F, H, W), poses_wc (F, 4, 4)).
    """
    if scene is None:
        scene = default_scene()
    if poses is None:
        poses = _random_walk_poses(num_frames, seed, step_scale)
    depths = jax.vmap(lambda T: render_depth(intr, T, scene))(poses)
    return depths, poses


def render_trajectory_rgbd(
    intr: camera.Intrinsics,
    num_frames: int,
    scene: Scene | None = None,
    seed: int = 0,
    step_scale: float = 0.02,
    poses: jnp.ndarray | None = None,
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """RGB-D random-walk trajectory: (depths (F,H,W), colors (F,H,W,3), poses)."""
    if scene is None:
        scene = default_scene()
    if poses is None:
        poses = _random_walk_poses(num_frames, seed, step_scale)
    depths, colors = jax.vmap(lambda T: render_rgbd(intr, T, scene))(poses)
    return depths, colors, poses
