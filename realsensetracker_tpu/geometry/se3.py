"""SE(3) Lie-group utilities, pure jnp and fully jit/vmap-compatible.

The reference represents rigid transforms as ``Eigen::Isometry3f`` and never
needs exp/log because Ceres/SVD produce rotations directly
(align_icp.cpp:139-151, gicp_cost.hpp:44-46). This rebuild solves 6x6
Gauss-Newton normal equations on se(3) twists, so the exp/log maps are
first-class here. Canonical pose representation: a 4x4 float matrix ``T``
with ``T[:3,:3]=R``, ``T[:3,3]=t`` (row-vector-free, points are (N,3)).

All functions broadcast over leading batch dimensions.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# Default matmul precision may round operands to bf16 or TF32 (~5e-4
# relative error) -- catastrophic for millimeter-scale geometry. Every matmul in this module is
# tiny (3x3 / 4x4 contractions), so full f32 precision costs nothing.
_HI = jax.lax.Precision.HIGHEST

_EPS = 1e-8


def identity(dtype=jnp.float32) -> jnp.ndarray:
    return jnp.eye(4, dtype=dtype)


def from_rt(R: jnp.ndarray, t: jnp.ndarray) -> jnp.ndarray:
    """Build 4x4 pose(s) from rotation(s) (...,3,3) and translation(s) (...,3)."""
    batch = jnp.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = jnp.broadcast_to(R, batch + (3, 3))
    t = jnp.broadcast_to(t, batch + (3,))
    top = jnp.concatenate([R, t[..., :, None]], axis=-1)
    bottom = jnp.zeros(batch + (1, 4), dtype=R.dtype).at[..., 0, 3].set(1.0)
    return jnp.concatenate([top, bottom], axis=-2)


def rotation(T: jnp.ndarray) -> jnp.ndarray:
    return T[..., :3, :3]


def translation(T: jnp.ndarray) -> jnp.ndarray:
    return T[..., :3, 3]


def compose(Ta: jnp.ndarray, Tb: jnp.ndarray) -> jnp.ndarray:
    """Ta @ Tb (apply Tb first, then Ta) - matches Eigen operator* semantics."""
    return jnp.matmul(Ta, Tb, precision=_HI)


def inverse(T: jnp.ndarray) -> jnp.ndarray:
    R = rotation(T)
    t = translation(T)
    Rt = jnp.swapaxes(R, -1, -2)
    return from_rt(
        Rt, -jnp.squeeze(jnp.matmul(Rt, t[..., :, None], precision=_HI), -1)
    )


def transform_points(T: jnp.ndarray, points: jnp.ndarray) -> jnp.ndarray:
    """Apply pose(s) to points (..., N, 3) at full f32 precision."""
    R = rotation(T)
    t = translation(T)
    return (
        jnp.matmul(points, jnp.swapaxes(R, -1, -2), precision=_HI)
        + t[..., None, :]
    )


@jax.jit
def orthonormalize(T: jnp.ndarray) -> jnp.ndarray:
    """Project an accumulated pose back onto SE(3) (nearest rotation by SVD).

    Pose-feedback loops of the form
    ``pose = compose(kf, register(init=inverse(kf) @ pose))`` AMPLIFY
    rotation denormalization: inverse() uses the rigid R-transpose
    shortcut, so a column-scale error e in R returns as ~2e in the warm
    start and compounds ~3x per frame -- measured growing from a 2e-7
    seed to 1e-2 by frame 12, which collapses tracking. One 3x3 SVD at
    each accumulation point removes the instability.
    """
    R = rotation(T)
    t = translation(T)
    u, _, vt = jnp.linalg.svd(R)
    Rn = jnp.matmul(u, vt, precision=_HI)
    det = jnp.linalg.det(Rn)
    Rn = Rn.at[..., :, 2].multiply(jnp.where(det < 0, -1.0, 1.0)[..., None])
    return from_rt(Rn, t)


@jax.jit
def accumulate(T_prev: jnp.ndarray, T_delta: jnp.ndarray) -> jnp.ndarray:
    """orthonormalize(compose(T_prev, T_delta)) as ONE jitted dispatch.

    The streaming trackers run this once per frame on the host path; the
    eager op-by-op form would cost several dispatches instead of one.
    """
    return orthonormalize(compose(T_prev, T_delta))


def transform_points_t(T: jnp.ndarray, points_t: jnp.ndarray) -> jnp.ndarray:
    """Apply a pose to LANE-MAJOR points (3, N) -> (3, N), f32 precision.

    The projective hot loop keeps the point axis minor-most; XLA handles
    either layout.
    """
    R = rotation(T)
    t = translation(T)
    return jnp.matmul(R, points_t, precision=_HI) + t[:, None]


def hat(w: jnp.ndarray) -> jnp.ndarray:
    """so(3) hat operator: (...,3) -> (...,3,3) skew-symmetric."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zero = jnp.zeros_like(wx)
    return jnp.stack(
        [
            jnp.stack([zero, -wz, wy], axis=-1),
            jnp.stack([wz, zero, -wx], axis=-1),
            jnp.stack([-wy, wx, zero], axis=-1),
        ],
        axis=-2,
    )


def exp_so3(w: jnp.ndarray) -> jnp.ndarray:
    """Rodrigues' formula, numerically stable near zero via Taylor guards.

    Autodiff-safe: the non-Taylor branch is evaluated at a safe theta when
    small so jnp.where never propagates NaN gradients (the untaken branch
    of a where still gets differentiated).
    """
    theta2 = jnp.sum(w * w, axis=-1)
    W = hat(w)
    W2 = jnp.matmul(W, W, precision=_HI)
    small = theta2 < 1e-4
    t2s = jnp.where(small, 1.0, theta2)  # safe denominator
    ts = jnp.sqrt(t2s)
    a = jnp.where(small, 1.0 - theta2 / 6.0, jnp.sin(ts) / ts)
    b = jnp.where(small, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(ts)) / t2s)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), W.shape)
    return eye + a[..., None, None] * W + b[..., None, None] * W2


def log_so3(R: jnp.ndarray) -> jnp.ndarray:
    """Inverse of exp_so3. Valid for theta in [0, pi); stable near zero."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = jnp.clip((trace - 1.0) * 0.5, -1.0 + 1e-7, 1.0 - 1e-7)
    theta = jnp.arccos(cos_theta)
    vee = jnp.stack(
        [
            R[..., 2, 1] - R[..., 1, 2],
            R[..., 0, 2] - R[..., 2, 0],
            R[..., 1, 0] - R[..., 0, 1],
        ],
        axis=-1,
    )
    small = theta < 1e-2
    theta_safe = jnp.where(small, 1.0, theta)  # NaN-gradient guard
    scale = jnp.where(
        small, 0.5 + theta**2 / 12.0, theta_safe / (2.0 * jnp.sin(theta_safe))
    )
    return scale[..., None] * vee


def exp(twist: jnp.ndarray) -> jnp.ndarray:
    """se(3) exponential map. twist = (..., 6) as [v (trans), w (rot)]."""
    v = twist[..., :3]
    w = twist[..., 3:]
    theta2 = jnp.sum(w * w, axis=-1)
    W = hat(w)
    W2 = jnp.matmul(W, W, precision=_HI)
    small = theta2 < 1e-4
    t2s = jnp.where(small, 1.0, theta2)  # NaN-gradient guard
    ts = jnp.sqrt(t2s)
    b = jnp.where(small, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(ts)) / t2s)
    c = jnp.where(
        small, 1.0 / 6.0 - theta2 / 120.0, (ts - jnp.sin(ts)) / (t2s * ts)
    )
    eye = jnp.broadcast_to(jnp.eye(3, dtype=twist.dtype), W.shape)
    V = eye + b[..., None, None] * W + c[..., None, None] * W2
    R = exp_so3(w)
    t = jnp.squeeze(jnp.matmul(V, v[..., :, None], precision=_HI), -1)
    return from_rt(R, t)


def log(T: jnp.ndarray) -> jnp.ndarray:
    """se(3) logarithm map: 4x4 pose -> (...,6) twist [v, w]."""
    R = rotation(T)
    t = translation(T)
    w = log_so3(R)
    theta2 = jnp.sum(w * w, axis=-1)
    W = hat(w)
    W2 = jnp.matmul(W, W, precision=_HI)
    small = theta2 < 1e-4
    t2s = jnp.where(small, 1.0, theta2)  # NaN-gradient guard
    ts = jnp.sqrt(t2s)
    # V^{-1} = I - W/2 + (1/theta^2)(1 - theta sin / (2(1-cos))) W^2
    coef = jnp.where(
        small,
        1.0 / 12.0 + theta2 / 720.0,
        (1.0 - ts * jnp.sin(ts) / (2.0 * (1.0 - jnp.cos(ts)))) / t2s,
    )
    eye = jnp.broadcast_to(jnp.eye(3, dtype=T.dtype), W.shape)
    Vinv = eye - 0.5 * W + coef[..., None, None] * W2
    v = jnp.squeeze(jnp.matmul(Vinv, t[..., :, None], precision=_HI), -1)
    return jnp.concatenate([v, w], axis=-1)


def quaternion_from_matrix(R: jnp.ndarray) -> jnp.ndarray:
    """Rotation matrix -> quaternion (x, y, z, w), Eigen coeffs() order.

    Branch-free Shepperd-style selection so it vmaps/jits cleanly.
    """
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    # Four candidate solutions; pick the one with the largest pivot.
    qw0 = jnp.sqrt(jnp.maximum(1.0 + tr, 0.0) + _EPS) * 0.5
    q0 = jnp.stack(
        [(m21 - m12), (m02 - m20), (m10 - m01), 4.0 * qw0 * qw0], axis=-1
    ) / (4.0 * qw0[..., None])
    qx1 = jnp.sqrt(jnp.maximum(1.0 + m00 - m11 - m22, 0.0) + _EPS) * 0.5
    q1 = jnp.stack(
        [4.0 * qx1 * qx1, (m01 + m10), (m02 + m20), (m21 - m12)], axis=-1
    ) / (4.0 * qx1[..., None])
    qy2 = jnp.sqrt(jnp.maximum(1.0 - m00 + m11 - m22, 0.0) + _EPS) * 0.5
    q2 = jnp.stack(
        [(m01 + m10), 4.0 * qy2 * qy2, (m12 + m21), (m02 - m20)], axis=-1
    ) / (4.0 * qy2[..., None])
    qz3 = jnp.sqrt(jnp.maximum(1.0 - m00 - m11 + m22, 0.0) + _EPS) * 0.5
    q3 = jnp.stack(
        [(m02 + m20), (m12 + m21), 4.0 * qz3 * qz3, (m10 - m01)], axis=-1
    ) / (4.0 * qz3[..., None])
    cand = jnp.stack([q0, q1, q2, q3], axis=-2)
    pivots = jnp.stack([tr, m00 - m11 - m22, m11 - m00 - m22, m22 - m00 - m11], axis=-1)
    idx = jnp.argmax(pivots, axis=-1)
    q = jnp.take_along_axis(cand, idx[..., None, None].repeat(4, -1), axis=-2)[
        ..., 0, :
    ]
    # Normalize; canonicalize sign (w >= 0) for deterministic output.
    q = q / jnp.linalg.norm(q, axis=-1, keepdims=True)
    return q * jnp.where(q[..., 3:4] < 0, -1.0, 1.0)


def matrix_from_quaternion(q: jnp.ndarray) -> jnp.ndarray:
    """Quaternion (x, y, z, w) -> rotation matrix."""
    q = q / jnp.linalg.norm(q, axis=-1, keepdims=True)
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return jnp.stack(
        [
            jnp.stack(
                [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
                axis=-1,
            ),
            jnp.stack(
                [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
                axis=-1,
            ),
            jnp.stack(
                [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
                axis=-1,
            ),
        ],
        axis=-2,
    )


def orthogonalize(R: jnp.ndarray) -> jnp.ndarray:
    """Project a near-rotation onto SO(3) via SVD with determinant fix.

    Det-fix convention note: THIS flips a column of U before composing
    (the Kabsch-correct nearest rotation), while orthonormalize() and
    align/kabsch.py flip a column of the composed R -- the reference's own
    quirk (align_icp.cpp:61-63), kept there for behavioral parity. The two
    styles differ only for reflections (det < 0, which renormalization of
    a near-rotation never hits); do not "harmonize" them."""
    u, _, vt = jnp.linalg.svd(R)
    det = jnp.linalg.det(jnp.matmul(u, vt, precision=_HI))
    u = u.at[..., :, 2].multiply(jnp.sign(det)[..., None])
    return jnp.matmul(u, vt, precision=_HI)
