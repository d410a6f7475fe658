"""Checks that need the GPU (marker ``gpu``).

The pytest process itself is held on the CPU (conftest.py), so each check
runs in a fresh subprocess that JAX starts on the card. Whether a card is
present is decided once, inside a fixture, by such a subprocess; without
one every test here skips with the reason. On the card, run them with one
worker, so that only one JAX process holds the card at a time:

    python -m pytest tests/test_gpu.py -m gpu -p no:xdist -q

The identity checks answer, on the card, the claims the code makes that a
windowed, slab-restricted, deferred or slot-split program gives the same
numbers as the plain one: each is held to IDENTITY_TOL, which is 0 where
the card reproduced the claim exactly and otherwise says why not.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

pytestmark = pytest.mark.gpu

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Max abs difference allowed between the two programs of each claim. On
# one H100 every claim held exactly except the slot split: an 8-slot
# masked step and the same slots as two 4-slot steps (what each device of
# a 2-way data mesh runs) differed by 5.4e-7 -- the batched GN products of
# a different batch size may be summed in another order.
IDENTITY_TOL = {
    "keyframe window vs per-frame poses": 0.0,
    "slam window vs per-frame poses": 0.0,
    "slam deferred vs synchronous booking poses": 0.0,
    "tsdf window vs per-frame poses": 0.0,
    "tsdf slab vs full-volume tsdf": 0.0,
    "masked window vs sequential masked steps poses": 0.0,
    "masked step leaves inactive slots": 0.0,
    "8-slot step vs two 4-slot halves poses": 1e-5,
}


def _run_on_gpu(code: str, timeout: float = 1800) -> subprocess.CompletedProcess:
    """Run `code` in a fresh interpreter without the conftest's CPU forcing."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=timeout)


@pytest.fixture(scope="session")
def gpu():
    probe = _run_on_gpu("import jax; print(jax.devices()[0].platform)",
                        timeout=300)
    platform = probe.stdout.strip().splitlines()[-1:] or ["none"]
    if probe.returncode != 0 or platform[0] != "gpu":
        pytest.skip(f"needs a GPU; JAX's first device here is {platform[0]}")


def _run_phase(name: str, fn: str, *args: str) -> None:
    """Run chip_smoke's phase `fn` on the card; fails if any check does."""
    proc = _run_on_gpu(
        "import os, sys\n"
        "import chip_smoke as cs\n"
        "from realsensetracker_tpu.utils import device\n"
        "device.enable_compile_cache()\n"
        "os.makedirs(cs.SCRATCH, exist_ok=True)\n"
        "clip = os.path.join(cs.SCRATCH, 'loop.rsc')\n"
        f"ok = cs.run_phase({name!r}, cs.{fn}, {', '.join(args)})\n"
        "sys.exit(0 if ok else 1)\n")
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]


def test_plane_table_matches_oracle_on_gpu(gpu):
    _run_phase("plane_table", "phase_plane_table", "0", "8")


def test_registration_parity_on_gpu(gpu):
    _run_phase("registration_parity", "phase_registration_parity", "0")


def test_slam_replay_on_gpu(gpu):
    _run_phase("slam_replay", "phase_slam", "clip", "*cs.loop_clip(clip, 0)")


def test_identity_claims_on_gpu(gpu):
    proc = _run_on_gpu(
        "import json\n"
        "from tests.test_gpu import identity_report\n"
        "print(json.dumps(identity_report()))\n")
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    print(report)
    assert set(report) == set(IDENTITY_TOL)
    bad = {k: v for k, v in report.items() if v > IDENTITY_TOL[k]}
    assert not bad, bad


def identity_report() -> dict:
    """{claim: max abs difference} for each identity claim, measured on
    whatever device JAX runs on (the tests above run it on the card)."""
    import jax.numpy as jnp

    from realsensetracker_tpu.align import projective
    from realsensetracker_tpu.data import synthetic
    from realsensetracker_tpu.geometry import camera, se3
    from realsensetracker_tpu.mapping import tsdf
    from realsensetracker_tpu.parallel import streams
    from realsensetracker_tpu.tracking.keyframe import KeyframeTracker
    from realsensetracker_tpu.tracking.slam import SlamConfig, SlamTracker
    from realsensetracker_tpu.tracking.tsdf_tracker import TsdfTracker

    intr = camera.Intrinsics(fx=100.0, fy=100.0, cx=49.5, cy=37.0,
                             width=100, height=75)
    cfg = projective.ProjectiveIcpConfig(iters=(4, 4, 5), samples=1024)
    scene = synthetic.default_scene(seed=21)
    step = jnp.asarray([0.03, 0.0, 0.02, 0.0, 0.025, 0.0], jnp.float32)
    poses = [se3.identity()]
    for i in range(9):
        poses.append(se3.compose(poses[-1], se3.exp(step if i < 5 else -step)))
    depths = [synthetic.render_depth(intr, T, scene) for T in poses]
    out = {}

    def diff(a, b):
        return float(np.abs(np.asarray(a, np.float64)
                            - np.asarray(b, np.float64)).max())

    def traj(tr):
        return np.stack(tr.trajectory.poses)

    kf_a, kf_b = KeyframeTracker(intr, cfg), KeyframeTracker(intr, cfg)
    for i, d in enumerate(depths):
        kf_a.process(d, float(i))
    done = 0
    while done < len(depths):
        done += len(kf_b.process_window(
            depths[done:done + 4], [float(j) for j in range(done, done + 4)]))
    out["keyframe window vs per-frame poses"] = diff(traj(kf_a), traj(kf_b))

    def slam(**kw):
        c = SlamConfig(intrinsics=intr, icp=cfg, loop_min_separation=3,
                       loop_similarity=0.8, keyframe_cloud_capacity=1024, **kw)
        c.align.fpfh_max_neighbors = 32
        t = SlamTracker(c)
        t._vo.max_translation = 0.05
        t._vo.max_rotation = 0.05
        return t

    s_ref, s_win, s_sync = slam(), slam(), slam(defer_keyframe_booking=False)
    for i, d in enumerate(depths):
        s_ref.process(d, float(i))
        s_sync.process(d, float(i))
    done = 0
    while done < len(depths):
        done += len(s_win.process_window(
            depths[done:done + 4], [float(j) for j in range(done, done + 4)],
            window=4))
    out["slam window vs per-frame poses"] = diff(traj(s_ref), traj(s_win))
    out["slam deferred vs synchronous booking poses"] = diff(traj(s_ref),
                                                             traj(s_sync))

    small = camera.Intrinsics(fx=64.0, fy=64.0, cx=39.5, cy=29.5,
                              width=80, height=60)
    vcfg = tsdf.TsdfConfig(resolution=64, voxel_size=0.1,
                           origin=(-3.2, -2.4, -0.3), trunc=0.3, max_range=5.0)
    icp = projective.ProjectiveIcpConfig(iters=(3, 3), inner_iters=2,
                                         samples=768, min_samples=192)
    seq, _ = synthetic.render_trajectory(
        small, 7, scene=synthetic.default_scene(seed=3), seed=1,
        step_scale=0.01)
    seq = [np.asarray(d) for d in seq]
    t_a = TsdfTracker(small, volume=vcfg, icp=icp)
    t_b = TsdfTracker(small, volume=vcfg, icp=icp)
    for i, d in enumerate(seq):
        t_a.process(d, float(i))
    t_b.process_window(seq, [float(i) for i in range(len(seq))], window=3)
    out["tsdf window vs per-frame poses"] = diff(traj(t_a), traj(t_b))

    # A near-field scene (wall at 2.4 m) whose frusta fit a 48^3 slab, as
    # in tests/test_tsdf_integrate_slab.py.
    near = synthetic.Scene(
        sphere_centers=jnp.asarray([[0.3, 0.1, 1.6], [-0.4, -0.2, 1.9]],
                                   jnp.float32),
        sphere_radii=jnp.asarray([0.35, 0.3], jnp.float32),
        floor_y=0.8, wall_z=2.4)
    slab = vcfg._replace(integrate_slab=48)
    v_full, v_slab = tsdf.init_volume(vcfg), tsdf.init_volume(slab)
    for i in range(3):
        T = se3.from_rt(jnp.eye(3, dtype=jnp.float32),
                        jnp.asarray([0.1 * i, 0.05 * i, 0.0], jnp.float32))
        d = synthetic.render_depth(small, T, near)
        v_full = tsdf.integrate(v_full, d, T, small, vcfg)
        v_slab = tsdf.integrate(v_slab, d, T, small, slab)
    out["tsdf slab vs full-volume tsdf"] = diff(v_full.tsdf, v_slab.tsdf)

    S = 8
    frames = jnp.stack([synthetic.render_depth(small, se3.exp(jnp.asarray(
        [0.01 * s, -0.004 * s, 0.02, 0.003 * s, 0.0, -0.002 * s],
        jnp.float32)), synthetic.default_scene(seed=7)) for s in range(2 * S)])
    on, off = jnp.ones((S,), bool), jnp.zeros((S,), bool)
    st, _ = streams.step_streams_masked(
        streams.blank_streams(small, num_streams=S), frames[:S], on, on, small)
    st2, _ = streams.step_streams_masked(st, frames[S:], on, off, small)
    win, _ = streams.step_streams_masked_window(
        streams.blank_streams(small, num_streams=S),
        jnp.stack([frames[:S], frames[S:]], axis=1), jnp.ones((S, 2), bool),
        jnp.stack([on, off], axis=1), small)
    out["masked window vs sequential masked steps poses"] = diff(win.poses,
                                                                 st2.poses)
    half = jnp.arange(S) < S // 2
    st_h, _ = streams.step_streams_masked(st, frames[S:], half, off, small)
    out["masked step leaves inactive slots"] = diff(
        st_h.poses[S // 2:], st.poses[S // 2:])
    halves = [streams.step_streams_masked(
        streams.step_streams_masked(
            streams.blank_streams(small, num_streams=S // 2),
            frames[k:k + S // 2], on[:S // 2], on[:S // 2], small)[0],
        frames[S + k:S + k + S // 2], on[:S // 2], off[:S // 2], small)[0]
        for k in (0, S // 2)]
    out["8-slot step vs two 4-slot halves poses"] = diff(
        st2.poses, jnp.concatenate([h.poses for h in halves]))
    return out
