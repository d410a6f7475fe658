"""Pinhole camera model: intrinsics, project/unproject, pyramid scaling.

The reference obtains intrinsics from the RealSense color stream
(rs_driver.cpp:264-280) and computes point clouds on the CPU via
rs2::pointcloud::calculate (rs_driver.cpp:201-202). Here the camera model is
an explicit jittable op: depth images become vertex maps on-device, which is
the foundation of projective correspondence (the dense replacement for the
reference's per-point KD-tree queries, align_icp.cpp:105-121).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp


class Intrinsics(NamedTuple):
    """Pinhole intrinsics. Static Python floats/ints so shapes stay static."""

    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int

    def matrix(self) -> jnp.ndarray:
        return jnp.array(
            [[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy], [0.0, 0.0, 1.0]],
            dtype=jnp.float32,
        )

    def scaled(self, factor: float) -> "Intrinsics":
        """Intrinsics of an image downscaled by `factor` (e.g. 0.5 per level)."""
        return Intrinsics(
            fx=self.fx * factor,
            fy=self.fy * factor,
            cx=(self.cx + 0.5) * factor - 0.5,
            cy=(self.cy + 0.5) * factor - 0.5,
            width=int(round(self.width * factor)),
            height=int(round(self.height * factor)),
        )

    def halved(self) -> "Intrinsics":
        """Intrinsics of the next pyramid level.

        Dimensions FLOOR (width // 2), matching ops.pyramid.downsample_depth,
        which drops a trailing odd row/column before 2x2 pooling. scaled(0.5)
        rounds (487 -> 244), which would let in_bounds accept projections
        onto a row the level arrays do not have (the gather then silently
        clamps to the edge row). Identical to scaled(0.5) for even dims.
        """
        return Intrinsics(
            fx=self.fx * 0.5,
            fy=self.fy * 0.5,
            cx=(self.cx + 0.5) * 0.5 - 0.5,
            cy=(self.cy + 0.5) * 0.5 - 0.5,
            width=self.width // 2,
            height=self.height // 2,
        )


# TUM RGB-D "freiburg1" defaults (fr1/desk), the dataset named by BASELINE.md.
TUM_FR1 = Intrinsics(fx=517.3, fy=516.5, cx=318.6, cy=255.3, width=640, height=480)
# ROS/Kinect generic defaults, used by TUM tools when calibration is absent.
TUM_DEFAULT = Intrinsics(fx=525.0, fy=525.0, cx=319.5, cy=239.5, width=640, height=480)


def unproject_depth(depth: jnp.ndarray, intr: Intrinsics) -> jnp.ndarray:
    """Depth image (..., H, W) -> vertex map (..., H, W, 3) in camera frame.

    Invalid depths (<= 0 or non-finite) yield zero vertices; validity is
    recovered downstream via `valid_mask`. Equivalent role to the reference's
    ConvertPointCloud + RemoveNans (rs_driver.cpp:33-103,
    point_cloud_utils.cpp:163-174) but fixed-shape and mask-based.
    """
    h, w = depth.shape[-2], depth.shape[-1]
    u = jnp.arange(w, dtype=depth.dtype)
    v = jnp.arange(h, dtype=depth.dtype)
    uu, vv = jnp.meshgrid(u, v)
    d = jnp.where(jnp.isfinite(depth) & (depth > 0), depth, 0.0)
    # Multiply by the rounded reciprocal rather than divide: the same three
    # correctly rounded float32 operations in XLA, the GPU plane-table
    # kernel (ops/plane_kernel.py, whose division is approximate) and the
    # NumPy oracle, so all three build the same vertices bit for bit.
    x = d * (uu - intr.cx) * (1.0 / intr.fx)
    y = d * (vv - intr.cy) * (1.0 / intr.fy)
    return jnp.stack([x, y, d], axis=-1)


def valid_mask(depth: jnp.ndarray, min_depth: float = 1e-6, max_depth: float = jnp.inf) -> jnp.ndarray:
    return jnp.isfinite(depth) & (depth > min_depth) & (depth < max_depth)


def project(points: jnp.ndarray, intr: Intrinsics) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Points (..., 3) -> (u, v, z) pixel coordinates + depth.

    Returns floating-point pixel coordinates; callers gate on bounds and z>0.
    """
    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    z_safe = jnp.where(jnp.abs(z) > 1e-12, z, 1e-12)
    u = intr.fx * x / z_safe + intr.cx
    v = intr.fy * y / z_safe + intr.cy
    return u, v, z


def in_bounds(u: jnp.ndarray, v: jnp.ndarray, intr: Intrinsics, margin: float = 0.0) -> jnp.ndarray:
    return (
        (u >= margin)
        & (u <= intr.width - 1 - margin)
        & (v >= margin)
        & (v <= intr.height - 1 - margin)
    )
