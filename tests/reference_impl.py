"""Pure-NumPy transcription of the reference's registration math.

This is the golden oracle for parity tests: a faithful, scalar-looped NumPy
reimplementation of the C++ semantics (align_icp.cpp, point_cloud_utils.cpp,
fpfh.cpp, rs_align_app.cpp), written against SURVEY.md's behavioral notes.
Slow by design -- only run on small clouds.
"""

from __future__ import annotations

import numpy as np


def solve_kabsch_np(src, dst, pairs, weights=None):
    """SolveKabsch (align_icp.cpp:18-71). pairs: list of (i_src, i_dst)."""
    src = np.asarray(src, np.float32)
    dst = np.asarray(dst, np.float32)
    if len(src) < 3 or len(dst) < 3:
        return None
    src_mean = np.zeros(3, np.float32)
    dst_mean = np.zeros(3, np.float32)
    for i, j in pairs:
        src_mean += src[i]
        dst_mean += dst[j]
    src_mean /= len(pairs)
    dst_mean /= len(pairs)

    cov = np.zeros((3, 3), np.float64)
    for c, (i, j) in enumerate(pairs):
        w = 1.0 if weights is None else weights[c]
        cov += w * np.outer(dst[j] - dst_mean, src[i] - src_mean).astype(np.float64)

    u, _, vt = np.linalg.svd(cov)
    R = (u @ vt).astype(np.float32)
    if np.linalg.det(R) < 0:
        R[:, 2] *= -1
    t = dst_mean - R @ src_mean
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = R
    T[:3, 3] = t
    return T


def align_icp_np(src, dst, max_iter=128, init=None):
    """AlignIcp3d (align_icp.cpp:73-161): GNC-weighted SVD ICP.

    Returns (T, mean_cost). Brute-force exact 1-NN stands in for the KD-tree.
    """
    src = np.asarray(src, np.float32)
    dst = np.asarray(dst, np.float32)
    n = len(src)
    T = np.eye(4, dtype=np.float32) if init is None else np.array(init, np.float32)
    # C++ ComputeCentroid accumulates in float32 (point_cloud_utils.cpp:92-98)
    src_mean = np.zeros(3, np.float32)
    for i in range(n):
        src_mean += src[i]
    src_mean = src_mean * np.float32(1.0 / n)

    mu = np.float32(1.0)
    cost = np.float32(0.0)
    for it in range(max_iter):
        if it > 0 and it % 8 == 0:
            mu = np.float32(mu / np.float32(1.4))
        R, t = T[:3, :3], T[:3, 3]
        p = src @ R.T + t
        d2_all = ((p[:, None, :] - dst[None, :, :]) ** 2).sum(-1)
        nbrs = np.argmin(d2_all, axis=1)
        d2 = d2_all[np.arange(n), nbrs]
        cost = np.float32(d2.sum())
        l_rt = mu / (d2 + mu)
        w = (l_rt * l_rt).astype(np.float32)
        dst_mean = dst[nbrs].astype(np.float32).sum(0) / np.float32(n)

        cov = np.zeros((3, 3), np.float64)
        for i in range(n):
            cov += (
                w[i] * np.outer(dst[nbrs[i]] - dst_mean, src[i] - src_mean)
            ).astype(np.float64)

        u, _, vt = np.linalg.svd(cov)
        Rn = (u @ vt).astype(np.float32)
        if np.linalg.det(Rn) < 0:
            Rn[:, 2] *= -1
        tn = dst_mean - Rn @ src_mean
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = Rn
        T[:3, 3] = tn
    mean_cost = float(np.sqrt(cost / n))
    return T, mean_cost


def downsample_voxel_np(points, voxel_size):
    """DownsampleVoxel (point_cloud_utils.cpp:34-68): first-point-wins per
    voxel. Returns the selected point indices in insertion order."""
    seen = {}
    for i, p in enumerate(np.asarray(points, np.float32)):
        key = tuple(np.floor(p / voxel_size).astype(np.int64))
        if key not in seen:
            seen[key] = i
    return list(seen.values())


def compute_normals_np(points, k=16):
    """ComputeNormals (point_cloud_utils.cpp:176-204): kNN (self included),
    scatter-matrix eigendecomposition, smallest-eigenvalue eigenvector."""
    points = np.asarray(points, np.float32)
    n = len(points)
    d2 = ((points[:, None, :] - points[None, :, :]) ** 2).sum(-1)
    out = np.zeros((n, 3), np.float32)
    for i in range(n):
        idx = np.argsort(d2[i], kind="stable")[:k]
        nbrs = points[idx]
        ctr = nbrs.mean(0)
        delta = nbrs - ctr
        cov = delta.T @ delta
        vals, vecs = np.linalg.eigh(cov)
        out[i] = vecs[:, 0]
    return out


def orient_normals_np(points, normals, viewpoint):
    """OrientNormals (point_cloud_utils.cpp:206-216)."""
    normals = np.array(normals, np.float32)
    for i in range(len(points)):
        if np.dot(points[i] - viewpoint, normals[i]) > 0:
            normals[i] *= -1
    return normals


def compute_pfh_np(p1, n1, p2, n2):
    """ComputePfh (fpfh.cpp:21-67). Returns (f (3,), success)."""
    delta = p2 - p1
    distance = np.linalg.norm(delta)
    if distance == 0.0:
        return np.zeros(3, np.float32), False
    delta = delta / distance
    n1_d = float(np.dot(n1, delta))
    n2_d = float(np.dot(n2, delta))
    if abs(n1_d) < abs(n2_d):
        u_d, nt_d = -n2_d, -n1_d
    else:
        u_d, nt_d = n1_d, n2_d
    if abs(u_d) >= 1.0:
        return np.zeros(3, np.float32), False
    v_norm = np.sqrt(1.0 - u_d * u_d)
    n1n2 = float(np.dot(n1, n2))
    f = np.zeros(3, np.float32)
    f[0] = np.arctan2(nt_d - n1n2 * u_d, n1n2 * v_norm)
    f[1] = float(np.dot(delta, np.cross(n1, n2))) / v_norm
    f[2] = u_d
    return f, True


def compute_fpfh_np(points, normals, radius, pair_features=None):
    """ComputeSpfh + ComputeFpfhImpl (fpfh.cpp:69-176), radius neighborhoods.

    pair_features(i, j) -> (f, success) replaces compute_pfh_np on the
    pair (i, j) when given."""
    points = np.asarray(points, np.float32)
    n = len(points)
    num_bins, size = 11, 33
    scale = np.array([1.0 / (2 * np.pi), 0.5, 0.5])
    d = np.linalg.norm(points[:, None] - points[None, :], axis=-1)
    nbrs = [np.where(d[i] <= radius)[0] for i in range(n)]  # includes self

    spfhs = np.zeros((n, size), np.float32)
    for i in range(n):
        nb = nbrs[i]
        if len(nb) <= 1:
            continue
        dhist = 1.0 / (len(nb) - 1)
        for j in nb:
            if j == i:
                continue
            if pair_features is None:
                f, suc = compute_pfh_np(points[i], normals[i], points[j],
                                        normals[j])
            else:
                f, suc = pair_features(i, j)
            if suc:
                for k in range(3):
                    h = int(np.floor(num_bins * (f[k] * scale[k] + 0.5)))
                    h = max(0, min(num_bins - 1, h))
                    spfhs[i, k * num_bins + h] += dhist

    fpfh = np.zeros((n, size), np.float32)
    for i in range(n):
        for j in nbrs[i]:
            if j == i:
                continue
            fpfh[i] += (1.0 / d[i, j]) * spfhs[j]
        for k in range(3):
            seg = fpfh[i, k * num_bins : (k + 1) * num_bins]
            q = seg.sum()
            if q > 0:
                fpfh[i, k * num_bins : (k + 1) * num_bins] = seg / q
    return fpfh


def compute_covariances_np(points, k=32):
    """ComputeCovariances (point_cloud_utils.cpp:100-161), use_gicp=false:
    k+1-NN with self skipped, centered on the neighbor centroid,
    scatter / (k-1)."""
    points = np.asarray(points, np.float64)
    n = len(points)
    d2 = ((points[:, None] - points[None]) ** 2).sum(-1)
    covs = np.zeros((n, 3, 3))
    for i in range(n):
        idx = np.argsort(d2[i], kind="stable")[1 : k + 1]  # skip self
        nbrs = points[idx]
        delta = nbrs - nbrs.mean(0)
        covs[i] = delta.T @ delta / (k - 1)
    return covs


def _hat_np(w):
    return np.array(
        [[0.0, -w[2], w[1]], [w[2], 0.0, -w[0]], [-w[1], w[0], 0.0]]
    )


def _exp_se3_np(xi):
    """se(3) exponential, twist [v, w] (matches geometry/se3.py)."""
    v, w = np.asarray(xi[:3], np.float64), np.asarray(xi[3:], np.float64)
    th2 = float(w @ w)
    W = _hat_np(w)
    W2 = W @ W
    if th2 < 1e-12:
        R = np.eye(3) + W + 0.5 * W2
        V = np.eye(3) + 0.5 * W + W2 / 6.0
    else:
        th = np.sqrt(th2)
        a = np.sin(th) / th
        b = (1.0 - np.cos(th)) / th2
        c = (th - np.sin(th)) / (th2 * th)
        R = np.eye(3) + a * W + b * W2
        V = np.eye(3) + b * W + c * W2
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = V @ v
    return T


def _whitening_np(M):
    """Symmetric inverse square root (gicp_cost.hpp:57-68), eps-clamped."""
    vals, vecs = np.linalg.eigh(M)
    inv_sqrt = 1.0 / np.sqrt(np.maximum(vals, 1e-12))
    return (vecs * inv_sqrt[None, :]) @ vecs.T


def gicp_solve_np(
    src_pts,
    dst_pts,
    src_covs,
    dst_covs,
    seed,
    inner_iters=8,
    huber_delta=0.5,
    damping=1e-6,
):
    """Inner GICP NLLS solve: residual r = rsqrt(C_dst + R C_src R^T)
    (R p + t - q) per gicp_cost.hpp:40-73, Ceres HuberLoss(0.5) IRLS weights
    (align_gicp.cpp:67), damped Gauss-Newton on se(3) with re-whitening
    every iteration. Returns (T, cost) with cost = 0.5 * sum rho(|r|^2)
    (Ceres final_cost convention)."""
    src_pts = np.asarray(src_pts, np.float64)
    dst_pts = np.asarray(dst_pts, np.float64)
    T = np.array(seed, np.float64)
    b = huber_delta * huber_delta
    cost = 0.0
    n = len(src_pts)
    for _ in range(inner_iters):
        R = T[:3, :3]
        p = src_pts @ R.T + T[:3, 3]
        e = p - dst_pts
        H = np.zeros((6, 6))
        g = np.zeros(6)
        cost = 0.0
        for i in range(n):
            M = dst_covs[i] + R @ src_covs[i] @ R.T
            W = _whitening_np(M)
            r = W @ e[i]
            s = float(r @ r)
            w = 1.0 if s <= b else np.sqrt(b / max(s, 1e-30))
            J = np.concatenate([W, -W @ _hat_np(p[i])], axis=1)  # (3, 6)
            H += w * (J.T @ J)
            g += w * (J.T @ r)
            rho = s if s <= b else 2.0 * np.sqrt(b * max(s, 0.0)) - b
            cost += 0.5 * rho
        lam = damping * np.trace(H) + 1e-12
        delta = -np.linalg.solve(H + lam * np.eye(6), g)
        if not np.all(np.isfinite(delta)):
            delta = np.zeros(6)
        T = _exp_se3_np(delta) @ T
    return T.astype(np.float32), np.float32(cost)


def align_gicp_np(src, dst, max_outer=16, inner_iters=8, cov_k=32,
                  huber_delta=0.5, damping=1e-6):
    """Full GICP (outer ComputeAlignment, align_gicp.cpp:105-163): plain
    scatter covariances (use_gicp=false at :121-123), kMaxIter=16 rounds of
    brute-force 1-NN correspondences of (estimate * src) in dst, NLLS solve
    seeded from the running estimate, NaN guard keeps the previous pose.
    Returns (T, cost)."""
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    src_covs = compute_covariances_np(src, cov_k)
    dst_covs = compute_covariances_np(dst, cov_k)
    T = np.eye(4)
    cost = np.float32(0.0)
    for _ in range(max_outer):
        p = src @ T[:3, :3].T + T[:3, 3]
        d2 = ((p[:, None] - dst[None]) ** 2).sum(-1)
        nn = np.argmin(d2, axis=1)
        T_new, cost = gicp_solve_np(
            src, dst[nn], src_covs, dst_covs[nn], T,
            inner_iters=inner_iters, huber_delta=huber_delta, damping=damping,
        )
        if np.all(np.isfinite(T_new)):
            T = T_new.astype(np.float64)
    return T.astype(np.float32), cost


def prune_matches_lowe_np(matches, src_fpfh, dst_fpfh, lowe_ratio):
    """PruneMatchesLowe (rs_align_app.cpp:177-217)."""
    pairs, weights = [], []
    k_var = 0.25 * 0.25
    for i in range(matches.shape[0]):
        j0, j1 = int(matches[i, 0]), int(matches[i, 1])
        d0 = float(((src_fpfh[i] - dst_fpfh[j0]) ** 2).sum())
        d1 = float(((src_fpfh[i] - dst_fpfh[j1]) ** 2).sum())
        if d0 < d1:
            if d0 < lowe_ratio * d1:
                pairs.append((i, j0))
                weights.append(np.exp(-d0 / k_var))
        else:
            if d1 < lowe_ratio * d0:
                pairs.append((i, j1))
                weights.append(np.exp(-d1 / k_var))
    return pairs, weights



def unproject_np(depth, fx, fy, cx, cy):
    """Depth (H, W) f32 meters -> camera-frame vertex map (H, W, 3)."""
    depth = np.asarray(depth, np.float32)
    h, w = depth.shape
    u = np.arange(w, dtype=np.float32)[None, :]
    v = np.arange(h, dtype=np.float32)[:, None]
    x = depth * (u - np.float32(cx)) * np.float32(1.0 / fx)
    y = depth * (v - np.float32(cy)) * np.float32(1.0 / fy)
    return np.stack([x, y, depth], axis=-1)


def plane_table_np(vmap, valid):
    """Plane table of one level: vertex map (H, W, 3) and vertex validity
    (H, W) -> (packed (4, H, W) = [nx, ny, nz, n . v], normal_ok (H, W)).
    Central-difference normals over interior pixels (slices, no
    wrap-around), oriented toward the camera; border pixels and pixels with
    an invalid 4-neighbour carry n = 0."""
    vmap = np.asarray(vmap, np.float32)
    h, w = valid.shape
    c = (slice(1, h - 1), slice(1, w - 1))
    du = vmap[1:-1, 2:] - vmap[1:-1, :-2]
    dv = vmap[2:, 1:-1] - vmap[:-2, 1:-1]
    n = np.cross(du, dv).astype(np.float32)
    norm = np.sqrt(np.sum(n * n, axis=-1, keepdims=True))
    ok = (valid[c] & valid[1:-1, 2:] & valid[1:-1, :-2] & valid[2:, 1:-1]
          & valid[:-2, 1:-1] & (norm[..., 0] > 1e-12))
    n = n / np.maximum(norm, np.float32(1e-12))
    flip = np.sum(n * vmap[c], axis=-1) > 0
    n = np.where(flip[..., None], -n, n)
    normals = np.zeros((h, w, 3), np.float32)
    normals[c] = np.where(ok[..., None], n, np.float32(0.0))
    normal_ok = np.zeros((h, w), bool)
    normal_ok[c] = ok
    d_plane = np.sum(vmap * normals, axis=-1)
    packed = np.concatenate([np.moveaxis(normals, -1, 0), d_plane[None]], 0)
    return packed.astype(np.float32), normal_ok


def build_pyramid_np(depth, fx, fy, cx, cy, num_levels=3, min_depth=0.05,
                     max_depth=10.0):
    """NumPy oracle for ops.pyramid.build_pyramid's levels.

    Returns one dict per level, fine to coarse, with keys vertex_map,
    packed, valid (vertex AND normal valid) and vertex_valid. Coarser
    levels are 2x2 means over the valid children (a coarse pixel is valid
    if any child is), with a trailing odd row/column dropped and the
    intrinsics halved as (c + 0.5) / 2 - 0.5."""
    d = np.asarray(depth, np.float32)
    valid = np.isfinite(d) & (d > min_depth) & (d < max_depth)
    d = np.where(valid, d, np.float32(0.0)).astype(np.float32)
    levels = []
    for _ in range(num_levels):
        vmap = unproject_np(d, fx, fy, cx, cy)
        packed, normal_ok = plane_table_np(vmap, valid)
        levels.append({"vertex_map": vmap, "packed": packed,
                       "valid": normal_ok & valid, "vertex_valid": valid})
        h2, w2 = d.shape[0] // 2, d.shape[1] // 2
        blocks = d[:2 * h2, :2 * w2].reshape(h2, 2, w2, 2)
        mask = valid[:2 * h2, :2 * w2].reshape(h2, 2, w2, 2)
        cnt = mask.sum(axis=(1, 3))
        total = np.where(mask, blocks, np.float32(0.0)).sum(axis=(1, 3))
        valid = cnt > 0
        d = np.where(valid, total / np.maximum(cnt, 1).astype(np.float32),
                     np.float32(0.0)).astype(np.float32)
        fx, fy = fx * 0.5, fy * 0.5
        cx, cy = (cx + 0.5) * 0.5 - 0.5, (cy + 0.5) * 0.5 - 0.5
    return levels
