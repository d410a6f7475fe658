"""Smoke test on the GPU: the tracker's main paths, end to end, at 640x480.

    python chip_smoke.py            # one card: every phase below
    python chip_smoke.py --gpus 4   # four cards: the multi-device check only

Phases (one card, all at camera.TUM_FR1, frames from data/synthetic.py):

1. device: JAX's first device must be a GPU (no CPU fallback).
2. plane_table: ops.pyramid.build_pyramid on the card (its plane table
   is the Triton kernel, ops/plane_kernel) against the NumPy oracle
   (tests/reference_impl.build_pyramid_np) and against the XLA
   composition; both timed for 1 and 512 frames beside a device fill and
   copy of the bytes the table must move (information).
3. registration_parity: align_icp, align_gicp and compute_fpfh against
   their NumPy oracles at the widths of the CPU parity tests; projective
   register_depth_pair against the same program compiled for the host CPU.
4. batched_registration: register_batch_chunked on 2048 pairs (chunk 512)
   recovers the seeded motions; pairs/s as information.
5. slam_replay: rs_replay --method slam over a recorded 120-frame
   out-and-back clip (ATE against the rendered poses), and --window 8
   against the per-frame trajectory.
6. dense: rs_replay --method tsdf (128^3) over the clip's first 30 frames.
7. serving: TrackingService over HTTP against a serial Tracker, then a
   batched executor with 8 sessions against serial frame-to-frame trackers.

Each phase prints one JSON line with its checks (value and limit) and the
device's peak_bytes_in_use. Any failed check exits non-zero. The last line
is {"ok": true, "device": {"platform", "kind", "count"}}. Scratch files go
to .data/chip_smoke/ inside the checkout.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import io
import json
import os
import shutil
import sys
import threading
import time
import traceback

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SCRATCH = os.path.join(HERE, ".data", "chip_smoke")

# ATE bounds from a CPU rehearsal of the same clip (seed 0, 120-frame
# out-and-back at 640x480, XLA:CPU, float32): SLAM 0.70 mm with 8
# keyframes and 1 loop closure, TSDF (first 30 frames) 1.66 mm. The bounds
# leave about 6x for the card's other rounding.
SLAM_ATE_LIMIT_M = 0.005
TSDF_ATE_LIMIT_M = 0.01


class Phase:
    """Collects one phase's checks and prints its JSON line."""

    def __init__(self, name: str):
        self.name = name
        self.checks: list[dict] = []
        self.info: dict = {}
        self.error: str | None = None
        self._t0 = time.perf_counter()

    def check(self, name: str, value, limit, ok: bool) -> None:
        self.checks.append({"name": name, "value": value, "limit": limit,
                            "ok": bool(ok)})

    def at_most(self, name: str, value: float, limit: float) -> None:
        self.check(name, float(value), limit, float(value) <= limit)

    @property
    def ok(self) -> bool:
        return self.error is None and all(c["ok"] for c in self.checks)

    def report(self) -> dict:
        import jax

        stats = jax.devices()[0].memory_stats() or {}
        rec = {"phase": self.name, "ok": self.ok,
               "seconds": round(time.perf_counter() - self._t0, 3),
               "checks": self.checks, "info": self.info,
               "peak_bytes_in_use": stats.get("peak_bytes_in_use")}
        if self.error:
            rec["error"] = self.error
        print(json.dumps(rec), flush=True)
        return rec


def run_phase(name: str, fn, *args) -> bool:
    """Run one phase; an exception fails the phase (traceback to stderr)
    and the remaining phases still run."""
    ph = Phase(name)
    try:
        fn(ph, *args)
    except Exception as e:  # a phase boundary: report, keep going
        traceback.print_exc()
        ph.error = f"{type(e).__name__}: {e}"[:500]
    return ph.report()["ok"]


def _ms(fn, *args, reps: int = 20) -> float:
    """Median wall time of fn(*args) over reps, each ending on the device."""
    import jax

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts) * 1e3)


def _pose_err(Ta, Tb) -> float:
    """Max abs difference over the 3x4 pose block."""
    return float(np.max(np.abs(np.asarray(Ta)[:3] - np.asarray(Tb)[:3])))


def _twist_err(T_est, T_true) -> float:
    from realsensetracker_tpu.geometry import se3

    return float(np.abs(np.asarray(
        se3.log(se3.compose(se3.inverse(T_true), T_est)))).max())


# -- 1. device --------------------------------------------------------------

def phase_device(ph: Phase) -> None:
    import jax

    from realsensetracker_tpu.utils import device

    info = device.describe()
    ph.info.update(info)
    print(f"device: {info['kind']} x{info['count']} "
          f"(nvidia-smi: {info['nvidia_smi']})", flush=True)
    ph.check("platform", jax.devices()[0].platform, "gpu",
             jax.devices()[0].platform == "gpu")


# -- 2. plane table ---------------------------------------------------------

def _oracle_levels(levels, intrs, depth):
    """Max diffs of build_pyramid levels against the NumPy oracle, each
    stage on the device's own input to it (tests/
    test_pyramid_plane_table.py::test_oracle_parity explains why)."""
    from tests import reference_impl as ref

    intr = intrs[0]
    oracle = ref.build_pyramid_np(depth, intr.fx, intr.fy, intr.cx, intr.cy,
                                  len(levels))
    out = {"pool_rel": 0.0, "vertex": 0.0, "packed": 0.0,
           "valid_mismatch": 0, "vertex_valid_mismatch": 0}
    for lv, want, li in zip(levels, oracle, intrs):
        vvalid = np.asarray(lv.vertex_valid)
        vmap = np.asarray(lv.vertex_map)
        out["vertex_valid_mismatch"] += int((vvalid != want["vertex_valid"]).sum())
        wd = want["vertex_map"][..., 2]
        out["pool_rel"] = max(out["pool_rel"], float(
            (np.abs(vmap[..., 2] - wd) / np.maximum(np.abs(wd), 1e-6)).max()))
        out["vertex"] = max(out["vertex"], float(np.abs(vmap - ref.unproject_np(
            vmap[..., 2], li.fx, li.fy, li.cx, li.cy)).max()))
        packed, nok = ref.plane_table_np(vmap, vvalid)
        out["valid_mismatch"] += int((np.asarray(lv.valid) != (nok & vvalid)).sum())
        out["packed"] = max(out["packed"], float(
            np.abs(np.asarray(lv.packed) - packed).max()))
    return out


def phase_plane_table(ph: Phase, seed: int, batch: int = 512) -> None:
    import jax
    import jax.numpy as jnp

    from realsensetracker_tpu.data import synthetic
    from realsensetracker_tpu.geometry import camera, se3
    from realsensetracker_tpu.ops import pyramid

    intr = camera.TUM_FR1
    scene = synthetic.default_scene(seed=seed)
    pose = se3.exp(jnp.asarray([0.02, -0.01, 0.03, 0.01, 0.02, -0.01],
                               jnp.float32))
    depth = synthetic.render_depth(intr, pose, scene).at[100:140, 200:260].set(0.0)
    build = jax.jit(lambda d: pyramid.build_pyramid(d, intr, 3))
    levels, intrs = build(depth)
    diffs = _oracle_levels(levels, intrs, np.asarray(depth))
    ph.at_most("pooled depth rel diff", diffs["pool_rel"], 1e-6)
    ph.at_most("vertex map max abs diff (m)", diffs["vertex"], 1e-5)
    ph.at_most("plane table max abs diff", diffs["packed"], 2e-5)
    ph.check("vertex validity mismatches", diffs["vertex_valid_mismatch"], 0,
             diffs["vertex_valid_mismatch"] == 0)
    ph.check("plane validity mismatches", diffs["valid_mismatch"], 0,
             diffs["valid_mismatch"] == 0)

    # Level-0 plane table (what a destination frame costs before ICP):
    # the Triton kernel and the XLA composition it replaces, against the
    # least traffic the table needs -- read 4 B/px of depth, write 16 B/px
    # -- as a device fill of those bytes, and a 16 B/px copy.
    kern = jax.jit(jax.vmap(lambda d: pyramid.plane_table(d, intr)))
    xla = jax.jit(jax.vmap(lambda d: pyramid._plane_table_xla(d, intr)))
    fill = jax.jit(lambda d: jnp.broadcast_to(d[:, None] * 1.5,
                                              (d.shape[0], 4) + d.shape[1:]))
    copy = jax.jit(lambda x: x * 1.5)
    frames = jnp.broadcast_to(depth, (batch,) + depth.shape) + \
        jnp.arange(batch, dtype=jnp.float32)[:, None, None] * 1e-4
    planes = jnp.zeros((batch, 4) + depth.shape, jnp.float32)
    ph.at_most("kernel vs XLA plane table max abs diff",
               jnp.abs(kern(frames[:2]) - xla(frames[:2])).max(), 2e-5)
    ph.info.update({
        "kernel_ms_1_frame": _ms(kern, frames[:1]),
        "xla_ms_1_frame": _ms(xla, frames[:1]),
        f"kernel_ms_{batch}_frames": _ms(kern, frames),
        f"xla_ms_{batch}_frames": _ms(xla, frames),
        f"fill_20Bpx_ms_{batch}_frames": _ms(fill, frames),
        f"copy_16Bpx_ms_{batch}_frames": _ms(copy, planes),
    })


# -- 3. registration parity -------------------------------------------------

_PFH_SCALE = np.asarray([1.0 / (2.0 * np.pi), 0.5, 0.5])  # fpfh.cpp:75


def _pair_margin(f, p1, n1, p2, n2) -> float:
    """How far ComputePfh's branches are from flipping for one pair with
    features f: the source/target switch (|n1.d| vs |n2.d|, fpfh.cpp:41)
    and each feature's distance to its nearest histogram bin edge."""
    d = (p2 - p1) / np.linalg.norm(p2 - p1)
    switch = abs(abs(float(np.dot(n1, d))) - abs(float(np.dot(n2, d))))
    t = 11.0 * (f * _PFH_SCALE + 0.5)
    edge = np.abs(t - np.round(t)) / (11.0 * _PFH_SCALE)  # feature units
    return min(switch, float(edge.min()))


def _fpfh_ties(pts, nrm, dev_feats, dev_ok, margin: float = 1e-5):
    """pair_features(i, j) for ref.compute_fpfh_np: the NumPy oracle's
    features, except on pairs where the card binned differently AND the
    oracle sits within `margin` of one of ComputePfh's branch points
    (switch or bin edge) -- a last-bit decision either way; there it takes
    the card's feature and records the pair in `.taken`."""
    from tests import reference_impl as ref

    def bins(f):
        return np.clip(np.floor(11.0 * (np.asarray(f) * _PFH_SCALE + 0.5)),
                       0, 10)

    def pair(i, j):
        f, ok = ref.compute_pfh_np(pts[i], nrm[i], pts[j], nrm[j])
        if ok and dev_ok[i, j] and (bins(f) != bins(dev_feats[i, j])).any():
            if _pair_margin(f, pts[i], nrm[i], pts[j], nrm[j]) < margin:
                pair.taken.append([int(i), int(j)])
                return dev_feats[i, j], True
        return f, ok

    pair.taken = []
    return pair


def phase_registration_parity(ph: Phase, seed: int) -> None:
    import jax
    import jax.numpy as jnp

    from realsensetracker_tpu.align import gicp as gicp_mod
    from realsensetracker_tpu.align import icp as icp_mod
    from realsensetracker_tpu.align import projective
    from realsensetracker_tpu.data import synthetic
    from realsensetracker_tpu.geometry import camera, se3
    from realsensetracker_tpu.ops import cloud as cloud_mod
    from realsensetracker_tpu.ops import fpfh as fpfh_mod
    from realsensetracker_tpu.ops import normals as normals_mod
    from tests import reference_impl as ref

    # align_icp: 120 points, 32 iterations (tests/test_align_parity.py).
    rng = np.random.RandomState(seed)
    src = rng.randn(120, 3).astype(np.float32)
    tw = rng.randn(6).astype(np.float32) * np.float32(0.1)
    T_true = np.asarray(se3.exp(jnp.asarray(tw)))
    dst = (src @ T_true[:3, :3].T + T_true[:3, 3]).astype(np.float32)
    T_ref, cost_ref = ref.align_icp_np(src, dst, max_iter=32)
    res = icp_mod.align_icp(cloud_mod.from_points(jnp.asarray(src)),
                            cloud_mod.from_points(jnp.asarray(dst)),
                            max_iter=32)
    ph.at_most("align_icp pose vs oracle", _pose_err(res.transform, T_ref), 1e-4)
    ph.at_most("align_icp cost vs oracle",
               abs(float(res.mean_cost) - cost_ref), 1e-4)

    # align_gicp: 50 points, 6 outer x 4 inner, k=8 (tests/test_gicp.py).
    src = rng.randn(50, 3).astype(np.float32)
    T_true = np.asarray(se3.exp(jnp.array(
        [0.03, 0.02, -0.03, -0.02, 0.03, 0.02], jnp.float32)))
    dst = (src @ T_true[:3, :3].T + T_true[:3, 3]
           + 0.005 * rng.randn(50, 3)).astype(np.float32)
    T_ref, _ = ref.align_gicp_np(src, dst, max_outer=6, inner_iters=4, cov_k=8)
    res = gicp_mod.align_gicp(cloud_mod.from_points(jnp.asarray(src)),
                              cloud_mod.from_points(jnp.asarray(dst)),
                              max_outer=6, inner_iters=4, cov_k=8)
    ph.at_most("align_gicp twist vs oracle",
               _twist_err(res.transform, jnp.asarray(T_ref)), 1e-4)

    # compute_fpfh: 50 points, k=8 normals, radius 0.8 (tests/test_fpfh.py).
    # The oracle takes the device's oriented k-NN PCA normals, as the CPU
    # test does: the smallest-eigenvalue eigenvector of 8 random neighbours
    # is ill-conditioned, and the features are what is under test.
    pts = (0.5 * rng.randn(50, 3)).astype(np.float32)
    cloud = cloud_mod.from_points(jnp.asarray(pts))
    view = jnp.zeros(3, jnp.float32)
    f = fpfh_mod.compute_fpfh(cloud, view, normal_k=8, feature_radius=0.8,
                              max_neighbors=50)
    nrm = np.asarray(normals_mod.orient_normals(
        cloud.points, normals_mod.knn_pca_normals(cloud, k=8), view))
    dev_pairs, dev_ok = fpfh_mod.pair_features(
        jnp.asarray(pts)[:, None], jnp.broadcast_to(jnp.asarray(nrm)[:, None],
                                                    (50, 50, 3)),
        jnp.asarray(pts)[None], jnp.asarray(nrm)[None])
    ties = _fpfh_ties(pts, nrm, np.asarray(dev_pairs), np.asarray(dev_ok))
    f_ref = ref.compute_fpfh_np(pts, nrm, 0.8, pair_features=ties)
    ph.at_most("compute_fpfh max abs diff vs oracle",
               np.abs(np.asarray(f) - f_ref).max(), 1e-4)
    ph.check("fpfh pairs decided by the last bit", len(ties.taken),
             "<= 1% of pairs", len(ties.taken) <= 0.01 * 50 * 49)
    ph.info["fpfh_pairs_decided_by_last_bit"] = ties.taken

    # register_depth_pair at 640x480, flagship config: the card against the
    # same program compiled for the host CPU, and against the seeded motion.
    intr = camera.TUM_FR1
    motion = jnp.asarray([0.01, -0.005, 0.01, 0.005, -0.01, 0.005], jnp.float32)
    d0, d1, T_rel = synthetic.render_pair(intr, motion,
                                          synthetic.default_scene(seed=seed))
    reg = jax.jit(lambda s, d: projective.register_depth_pair(
        s, d, intr).transform)
    T_dev = reg(d1, d0)
    cpu = jax.devices("cpu")[0]
    T_cpu = jax.jit(reg, device=cpu)(jax.device_put(d1, cpu),
                                     jax.device_put(d0, cpu))
    ph.at_most("register_depth_pair pose: card vs host CPU",
               _pose_err(T_dev, T_cpu), 1e-4)
    ph.at_most("register_depth_pair twist vs seeded motion",
               _twist_err(T_dev, T_rel), 1e-3)


# -- 4. batched registration ------------------------------------------------

def phase_batched(ph: Phase, seed: int, n_pairs: int = 2048,
                  chunk: int = 512) -> None:
    import jax
    import jax.numpy as jnp

    from realsensetracker_tpu.align import projective
    from realsensetracker_tpu.data import synthetic
    from realsensetracker_tpu.geometry import camera, se3
    from realsensetracker_tpu.parallel import batched
    from realsensetracker_tpu.utils import device

    intr = camera.TUM_FR1
    cfg = projective.ProjectiveIcpConfig()
    scene = synthetic.default_scene(seed=seed)
    twists = np.random.RandomState(seed).uniform(
        -0.01, 0.01, (n_pairs, 6)).astype(np.float32)
    poses = jax.vmap(se3.exp)(jnp.asarray(twists))
    render = jax.jit(jax.vmap(lambda T: synthetic.render_depth(intr, T, scene)))
    step = min(256, n_pairs)
    src = jnp.concatenate([render(poses[i:i + step])
                           for i in range(0, n_pairs, step)])
    dst = jnp.broadcast_to(synthetic.render_depth(intr, se3.identity(), scene),
                           src.shape)
    reg = jax.jit(lambda s, d: batched.register_batch_chunked(
        s, d, intr, cfg, chunk).transform)
    T = np.asarray(reg(src, dst))  # compile + first run
    t0 = time.perf_counter()
    T = np.asarray(reg(src + 1e-5, dst))
    dt = time.perf_counter() - t0
    errs = np.asarray(jax.vmap(lambda a, b: jnp.abs(se3.log(
        se3.compose(se3.inverse(b), a))).max())(jnp.asarray(T), poses))
    ph.check("finite transforms", int(np.isfinite(T).all()), 1,
             bool(np.isfinite(T).all()))
    ph.at_most("max twist error vs seeded motion", errs.max(), 1e-3)
    ph.info.update({"pairs": n_pairs, "chunk": chunk,
                    "median_twist_error": float(np.median(errs)),
                    "pairs_per_s": n_pairs / dt,
                    "card": device.nvidia_smi_name_and_power()})


# -- 5./6. replay through the CLI -------------------------------------------

def loop_clip(path: str, seed: int, num_frames: int = 120):
    """Write an out-and-back clip at 640x480 (TUM_FR1 intrinsics): the
    second half retraces the first, so the last frames revisit the start.
    Returns the rendered world poses (F, 4, 4)."""
    import jax.numpy as jnp

    from realsensetracker_tpu.data import recorded, synthetic
    from realsensetracker_tpu.geometry import camera

    intr = camera.TUM_FR1
    step = jnp.asarray([0.01, 0.0, 0.004, 0.0, 0.008, 0.0], jnp.float32)
    half = num_frames // 2
    twists = jnp.stack([step] * half + [-step] * (num_frames - 1 - half))
    poses = synthetic.poses_from_twists(twists)
    depths, _ = synthetic.render_trajectory(
        intr, num_frames, scene=synthetic.default_scene(seed=seed), poses=poses)
    stamps = np.arange(num_frames, dtype=np.float64) / 30.0
    recorded.write_clip(path, np.asarray(depths), stamps, intr)
    return np.asarray(poses), stamps


def _replay(argv) -> str:
    from realsensetracker_tpu.cli import rs_replay

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = rs_replay.main(argv)
    if rc != 0:
        raise RuntimeError(f"rs_replay {argv} exited {rc}")
    return buf.getvalue()


def _ate(traj_path: str, poses, stamps) -> float:
    from realsensetracker_tpu.tracking.trajectory import (
        Trajectory,
        absolute_trajectory_error,
    )

    gt = Trajectory()
    for ts, T in zip(stamps, poses):
        gt.append(float(ts), T)
    return absolute_trajectory_error(Trajectory.load_tum(traj_path), gt)["rmse"]


def phase_slam(ph: Phase, clip: str, poses, stamps) -> None:
    from realsensetracker_tpu.tracking.trajectory import Trajectory

    per_frame = os.path.join(SCRATCH, "slam.txt")
    windowed = os.path.join(SCRATCH, "slam_w8.txt")
    out = _replay(["--record", clip, "--method", "slam",
                   "--trajectory-out", per_frame])
    summary = [ln for ln in out.splitlines() if ln.startswith("keyframes=")]
    ph.info["summary"] = summary[-1] if summary else ""
    ph.at_most("ATE rmse (m)", _ate(per_frame, poses, stamps), SLAM_ATE_LIMIT_M)
    _replay(["--record", clip, "--method", "slam", "--window", "8",
             "--trajectory-out", windowed])
    a = np.stack(Trajectory.load_tum(per_frame).poses)
    b = np.stack(Trajectory.load_tum(windowed).poses)
    ph.check("window 8 frames", len(b), len(a), len(a) == len(b))
    ph.at_most("window 8 vs per-frame max abs pose diff",
               np.abs(a - b).max() if a.shape == b.shape else np.inf, 1e-4)


def phase_dense(ph: Phase, clip: str, poses, stamps, frames: int = 30) -> None:
    traj = os.path.join(SCRATCH, "tsdf.txt")
    _replay(["--record", clip, "--method", "tsdf", "--max-frames", str(frames),
             "--trajectory-out", traj])
    ph.at_most("ATE rmse (m)", _ate(traj, poses[:frames], stamps[:frames]),
               TSDF_ATE_LIMIT_M)


# -- 7. serving -------------------------------------------------------------

def phase_serving(ph: Phase, clip: str, n_frames: int = 20,
                  sessions: int = 8, per_session: int = 4) -> None:
    from realsensetracker_tpu.api import Tracker, TrackerConfig
    from realsensetracker_tpu.api.batching import BatchedExecutor, BatchingConfig
    from realsensetracker_tpu.api.service import TrackingService, get_json, post_frame
    from realsensetracker_tpu.data import recorded

    c = recorded.read_clip(clip)
    intr = c.intrinsics
    frames = [np.round(d * 1000.0).astype(np.uint16) for d in c.depths]

    def serial(method, seq):
        tr = Tracker(TrackerConfig(intrinsics=intr, method=method,
                                   depth_scale=1e-3))
        return [np.asarray(tr.process(f, float(i)).pose)
                for i, f in enumerate(seq)]

    svc = TrackingService(lambda: Tracker(TrackerConfig(
        intrinsics=intr, method="keyframe", depth_scale=1e-3)))
    try:
        url = f"http://127.0.0.1:{svc.port}"
        got = [np.asarray(post_frame(url, frames[i], ts=float(i))["pose"])
               for i in range(n_frames)]
        ph.check("service frames", get_json(url, "/status")["frames"],
                 n_frames, get_json(url, "/status")["frames"] == n_frames)
    finally:
        svc.close()
    ph.at_most("service vs serial keyframe Tracker max abs pose diff",
               np.abs(np.stack(got) - np.stack(serial("keyframe",
                                                      frames[:n_frames]))).max(),
               1e-5)

    ex = BatchedExecutor(BatchingConfig(intrinsics=intr, capacity=sessions,
                                        linger_ms=50.0))
    svc = TrackingService(ex.make_session_tracker, extra_status=ex.stats)
    seqs = [frames[3 * s:3 * s + per_session] for s in range(sessions)]
    results: dict = {}
    errors: list = []
    try:
        url = f"http://127.0.0.1:{svc.port}"

        def worker(s):
            try:
                results[s] = [np.asarray(post_frame(
                    url, f, ts=float(i), session=f"s{s}")["pose"])
                    for i, f in enumerate(seqs[s])]
            except Exception as e:  # reported as a failed check below
                errors.append(f"s{s}: {type(e).__name__}: {e}")

        threads = [threading.Thread(target=worker, args=(s,))
                   for s in range(sessions)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        st = get_json(url, "/status")["batching"]
    finally:
        svc.close()
        ex.close()
    ph.check("batched session errors", errors, [], not errors)
    ph.info["batching"] = {k: st.get(k) for k in ("frames", "dispatches",
                                                  "mean_batch")}
    worst = 0.0
    for s in range(sessions):
        ref = np.stack(serial("projective", seqs[s]))
        got = np.stack(results.get(s, [np.full((4, 4), np.inf)]))
        worst = max(worst, float(np.abs(got - ref).max())
                    if got.shape == ref.shape else np.inf)
    ph.at_most("batched sessions vs serial projective Tracker max abs pose diff",
               worst, 1e-5)


# -- 4 cards ----------------------------------------------------------------

def phase_multichip(ph: Phase, n: int) -> None:
    sys.path.insert(0, HERE)
    import __graft_entry__

    checks = __graft_entry__.dryrun_multichip(n)
    for tag, c in checks.items():
        ph.at_most(tag, c["max_abs_diff"], c["atol"])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--gpus", type=int, default=1, choices=(1, 4),
                   help="4 runs only the multi-device check on 4 cards")
    args = p.parse_args(argv)

    from realsensetracker_tpu import native
    from realsensetracker_tpu.utils import device

    # Nothing below needs PIL; the clip reader uses the native library when
    # it is built (or cmake can build it) and its Python reader otherwise.
    print(json.dumps({
        "pil": importlib.util.find_spec("PIL") is not None,
        "native_library": next((p for p in native._lib_paths()
                                if os.path.exists(p)), None),
        "cmake": shutil.which("cmake") is not None,
    }), flush=True)

    device.enable_compile_cache()
    import jax

    if not run_phase("device", phase_device):
        return 1
    if args.gpus == 4:
        ok = run_phase("multichip", phase_multichip, 4)
    else:
        os.makedirs(SCRATCH, exist_ok=True)
        clip = os.path.join(SCRATCH, "loop.rsc")
        poses, stamps = loop_clip(clip, args.seed)
        ok = all([
            run_phase("plane_table", phase_plane_table, args.seed),
            run_phase("registration_parity", phase_registration_parity,
                      args.seed),
            run_phase("batched_registration", phase_batched, args.seed),
            run_phase("slam_replay", phase_slam, clip, poses, stamps),
            run_phase("dense", phase_dense, clip, poses, stamps),
            run_phase("serving", phase_serving, clip),
        ])
    if not ok:
        return 1
    devs = jax.devices()
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
