"""Benchmark: registered 640x480 depth-frame pairs/sec/chip.

Runs the flagship batched projective point-to-plane ICP pipeline (BASELINE
config 4: 64 pairs per step via vmap) on the GPU and prints ONE JSON line,
after a line naming the device and the card's power limit. Without a GPU
it fails; it never falls back to the CPU. vs_baseline is measured throughput / the BASELINE.json
north-star target of 1000 pairs/sec/chip (the reference publishes no numbers
of its own -- see SURVEY.md section 6).
"""

from __future__ import annotations

import json
import time


def _fresh_e2e() -> dict:
    """Companion end-to-end figure: u16 windowed keyframe registration
    through the production Tracker facade with freshly uploaded inputs.

    The headline loop below uploads its f32 batch ONCE, so it says nothing
    about host->device streaming. Here every frame is a DISTINCT u16
    buffer, uploaded inside the timed window dispatch.
    """
    import numpy as np

    from realsensetracker_tpu.api import Tracker, TrackerConfig
    from realsensetracker_tpu.data import synthetic
    from realsensetracker_tpu.geometry import camera

    intr = camera.TUM_FR1  # 640x480
    window = 8
    n_windows = 10  # timed

    # Smooth synthetic trajectory rendered once; per-frame u16 conversion
    # adds +-2 mm integer noise so every frame's BYTES are unique.
    scene = synthetic.default_scene(seed=5)
    total = window * (n_windows + 1)
    depths, _poses = synthetic.render_trajectory(
        intr, total, scene=scene, seed=3, step_scale=0.004
    )
    rng = np.random.RandomState(11)
    frames = []
    for i in range(total):
        d = np.asarray(depths[i])
        mm = np.clip(d * 1000.0, 0, 65000).astype(np.int32)
        mm = np.where(
            mm > 0, mm + rng.randint(-2, 3, size=mm.shape), 0
        )
        frames.append(mm.astype(np.uint16))

    tracker = Tracker(TrackerConfig(
        intrinsics=intr, method="keyframe", depth_scale=1e-3,
    ))
    # Warmup window: pays the scan compile, excluded from timing.
    tracker.process_window(frames[:window], window=window)

    t0 = time.perf_counter()
    for w in range(1, n_windows + 1):
        # The facade materializes the window's stats row per chunk --
        # the same fence rs_replay pays.
        tracker.process_window(
            frames[w * window:(w + 1) * window], window=window
        )
    dt = time.perf_counter() - t0
    n_frames = window * n_windows
    return {
        "fresh_u16_window8_ms_per_frame": round(dt * 1000.0 / n_frames, 2),
        "fresh_u16_window8_frames_per_sec": round(n_frames / dt, 1),
    }


def main() -> None:
    import jax
    import jax.numpy as jnp

    from realsensetracker_tpu.utils import device

    device.enable_compile_cache()
    info = device.describe()
    print(json.dumps({"device": info}), flush=True)
    device.require_gpu()

    from realsensetracker_tpu.align import projective
    from realsensetracker_tpu.data import synthetic
    from realsensetracker_tpu.geometry import camera
    from realsensetracker_tpu.parallel import batched

    intr = camera.TUM_FR1  # 640x480
    cfg = projective.ProjectiveIcpConfig()  # flagship defaults: (3,3,3,2) x 2
    # 2048 pairs per dispatch, registered as a scan over 4 chunks of 512
    # (parallel/batched.register_batch_chunked). BASELINE config 4's
    # 64-pair step is exercised in tests and rs_benchmark.
    batch, chunk = 2048, 512

    # Synthetic but geometrically real frames (raycast scene, small motion),
    # perturbed per pair so every batch element is distinct data.
    import numpy as np

    scene = synthetic.default_scene(seed=0)
    d0, d1, _ = synthetic.render_pair(
        intr, jnp.array([0.01, -0.005, 0.01, 0.005, -0.01, 0.005], jnp.float32), scene
    )
    rng = np.random.RandomState(0)

    def noisy(base):  # bounded host peak: generate noise 256 frames at a time
        base = np.asarray(base)
        return jnp.concatenate(
            [
                jnp.asarray(
                    base[None]
                    + 0.001 * rng.randn(min(256, batch - i), *base.shape).astype(np.float32)
                )
                for i in range(0, batch, 256)
            ]
        )

    src, dst = noisy(d1), noisy(d0)

    # Every timed dispatch gets distinct inputs (a per-step salt) and ends
    # with its (B, 4, 4) result on the host.
    import numpy as _np

    def step(s, d, salt):
        return batched.register_batch_chunked(s + salt, d + salt, intr, cfg, chunk).transform

    step_jit = jax.jit(step)
    # Warmup / compile (salt outside the timed range), hard-drained.
    _np.asarray(step_jit(src, dst, jnp.float32(-1e-4)))

    n_iters = 10
    salts = [jnp.float32((i + 1) * 1e-5) for i in range(n_iters)]
    t0 = time.perf_counter()
    for i in range(n_iters):
        # Materialize every step: honest steady-state wall clock.
        _np.asarray(step_jit(src, dst, salts[i]))
    dt = time.perf_counter() - t0

    # The timed program is a plain single-device jit: the whole batch runs
    # on ONE chip regardless of how many the host exposes, so the per-chip
    # rate IS the total rate (dividing by len(jax.devices()) would
    # under-report N-fold on a multi-chip host).
    value = pairs_per_sec = batch * n_iters / dt
    record = {
        "metric": "registered_640x480_pairs_per_sec_per_chip",
        "value": round(value, 2),
        "unit": "pairs/s/chip",
        "vs_baseline": round(value / 1000.0, 4),
    }
    record.update(_fresh_e2e())
    print(json.dumps(record))


if __name__ == "__main__":
    main()
