"""rs-benchmark: throughput/latency benchmark CLI.

Measures registered pairs/sec for any pipeline at any batch size and
resolution, with honest timing (distinct per-call inputs, blocking steady
state). The repo-root bench.py wraps the default flagship configuration.

Usage:
  python -m realsensetracker_tpu.cli.rs_benchmark --batch 64 --iters 10
  python -m realsensetracker_tpu.cli.rs_benchmark --pipeline gnc-icp --points 4096
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="rs-benchmark", description=__doc__)
    p.add_argument("--pipeline", default="projective-icp")
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--height", type=int, default=480)
    p.add_argument("--samples", type=int, default=2048)
    p.add_argument("--points", type=int, default=4096, help="cloud pipelines")
    # Flagship schedule: coarse -> fine association rounds.
    p.add_argument("--level-iters", default="3,3,3,2")
    p.add_argument("--inner-iters", type=int, default=2,
                   help="GN updates per association (gathers once per round)")
    p.add_argument("--chunk", type=int, default=0,
                   help="scan the batch in chunks of this size inside one "
                   "dispatch (0 = no chunking); amortizes dispatch overhead")
    p.add_argument("--window", type=int, default=8,
                   help="slam-window pipeline: frames scanned per dispatch")
    p.add_argument("--profile", default="", metavar="DIR",
                   help="capture a jax.profiler device trace of the timed "
                        "region into DIR (open with xprof/TensorBoard)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from realsensetracker_tpu.utils.device import enable_compile_cache

    enable_compile_cache()
    import contextlib

    import jax
    import jax.numpy as jnp

    from realsensetracker_tpu.align import projective
    from realsensetracker_tpu.data import synthetic
    from realsensetracker_tpu.geometry import camera

    intr = camera.Intrinsics(
        fx=args.width * 0.8, fy=args.width * 0.8,
        cx=(args.width - 1) / 2, cy=(args.height - 1) / 2,
        width=args.width, height=args.height,
    )
    rng = np.random.RandomState(0)

    def traced():
        # Wraps ONLY the timed region (post-warmup) so the trace shows
        # steady-state device work, not compilation.
        if args.profile:
            from realsensetracker_tpu.utils.profiling import device_trace

            return device_trace(args.profile)
        return contextlib.nullcontext()

    if args.pipeline == "projective-icp":
        from realsensetracker_tpu.parallel import batched

        iters = tuple(int(x) for x in args.level_iters.split(","))
        cfg = projective.ProjectiveIcpConfig(
            iters=iters, inner_iters=args.inner_iters, samples=args.samples
        )
        d0, d1, _ = synthetic.render_pair(
            intr, jnp.array([0.01, -0.005, 0.01, 0.005, -0.01, 0.005], jnp.float32)
        )
        src = jnp.asarray(np.asarray(d1)[None] + 0.001 * rng.randn(
            args.batch, args.height, args.width).astype(np.float32))
        dst = jnp.asarray(np.asarray(d0)[None] + 0.001 * rng.randn(
            args.batch, args.height, args.width).astype(np.float32))
        # Per-call salt perturbs inputs on-device: every timed dispatch is a
        # distinct execution.
        if args.chunk > 0:
            step = jax.jit(
                lambda s, d, salt: batched.register_batch_chunked(
                    s + salt, d + salt, intr, cfg, args.chunk
                ).transform
            )
        else:
            step = jax.jit(
                lambda s, d, salt: batched.register_batch(
                    s + salt, d + salt, intr, cfg
                ).transform
            )
        np.asarray(step(src, dst, jnp.float32(-1e-4)))  # warmup, hard drain
        salts = [jnp.float32((i + 1) * 1e-5) for i in range(args.iters)]
        with traced():
            t0 = time.perf_counter()
            for i in range(args.iters):
                # Materialize per call: each step ends with its result on
                # the host.
                np.asarray(step(src, dst, salts[i]))
            dt = time.perf_counter() - t0
        per_pair = args.batch * args.iters / dt
    elif args.pipeline == "rgbd":
        from realsensetracker_tpu.align import rgbd as rgbd_mod

        cfg = rgbd_mod.RgbdIcpConfig(samples=args.samples)
        ds, cs, _ = synthetic.render_trajectory_rgbd(intr, 2)
        g0 = synthetic.intensity_from_rgb(cs[0])
        g1 = synthetic.intensity_from_rgb(cs[1])
        src = jnp.asarray(np.asarray(ds[1])[None] + 0.001 * rng.randn(
            args.batch, args.height, args.width).astype(np.float32))
        dst = jnp.asarray(np.asarray(ds[0])[None] + 0.001 * rng.randn(
            args.batch, args.height, args.width).astype(np.float32))
        gs = jnp.broadcast_to(g1, (args.batch,) + g1.shape)
        gd = jnp.broadcast_to(g0, (args.batch,) + g0.shape)

        def one(sd, sg, dd, dg):
            return rgbd_mod.register_rgbd_pair(sd, sg, dd, dg, intr, cfg).transform

        step = jax.jit(
            lambda s, d, salt: jax.vmap(one)(s + salt, gs, d + salt, gd)
        )
        np.asarray(step(src, dst, jnp.float32(-1e-4)))  # warmup, hard drain
        salts = [jnp.float32((i + 1) * 1e-5) for i in range(args.iters)]
        with traced():
            t0 = time.perf_counter()
            for i in range(args.iters):
                np.asarray(step(src, dst, salts[i]))  # materialize per call
            dt = time.perf_counter() - t0
        per_pair = args.batch * args.iters / dt
    elif args.pipeline in ("gnc-icp", "gicp"):
        from realsensetracker_tpu.align import gicp as gicp_mod
        from realsensetracker_tpu.align import icp as icp_mod
        from realsensetracker_tpu.ops import cloud as cloud_mod

        if args.pipeline == "gnc-icp":
            def one(s, d):
                return icp_mod.align_icp(
                    cloud_mod.Cloud(s, jnp.ones(s.shape[0], bool)),
                    cloud_mod.Cloud(d, jnp.ones(d.shape[0], bool)),
                    128,
                ).transform
        else:
            def one(s, d):
                return gicp_mod.align_gicp(
                    cloud_mod.Cloud(s, jnp.ones(s.shape[0], bool)),
                    cloud_mod.Cloud(d, jnp.ones(d.shape[0], bool)),
                ).transform
        # Per-call salt: every timed dispatch is a distinct execution
        # (anti-memoization, see above).
        batch_run = jax.jit(lambda s, d, salt: jax.vmap(one)(s + salt, d + salt))
        src = jnp.asarray(rng.randn(args.batch, args.points, 3).astype(np.float32))
        dst = src + 0.01
        np.asarray(batch_run(src, dst, jnp.float32(-1e-4)))  # warmup, drain
        salts = [jnp.float32((i + 1) * 1e-5) for i in range(args.iters)]
        with traced():
            t0 = time.perf_counter()
            for i in range(args.iters):
                # Materialize per call (see above).
                np.asarray(batch_run(src, dst, salts[i]))
            dt = time.perf_counter() - t0
        per_pair = args.batch * args.iters / dt
    elif args.pipeline in ("slam", "slam-window"):
        # Streaming SLAM frames/sec over a synthetic trajectory: --batch
        # frames at the given resolution, per-frame dispatch ("slam") or
        # --window frames scanned per dispatch ("slam-window"). Every
        # frame is distinct data and every
        # process()/process_window() call materializes its stats to host,
        # so the timing is honest by construction.
        from realsensetracker_tpu.tracking.slam import SlamConfig, SlamTracker

        win = args.window if args.pipeline == "slam-window" else 0
        depths, _ = synthetic.render_trajectory(intr, args.batch, seed=0)
        frames = [jnp.asarray(depths[i]) for i in range(args.batch)]
        tracker = SlamTracker(SlamConfig(intrinsics=intr))

        def run(fr, base):
            ts = [float(base + i) / 30.0 for i in range(len(fr))]
            if win:
                tracker.process_window(fr, ts, window=win)
            else:
                for f, t in zip(fr, ts):
                    tracker.process(f, t)

        # Floor 2: the warmup must cover the seed frame AND the first
        # tracked step (its compile must not land in the timed region).
        skip = min(2 * max(win, 1), max(args.batch // 4, 2))
        run(frames[:skip], 0)  # warmup: compiles + first keyframes
        n_timed = args.batch - skip
        with traced():
            t0 = time.perf_counter()
            run(frames[skip:], skip)
            dt = time.perf_counter() - t0
        # Single-device program: the per-chip rate IS the measured rate.
        print(json.dumps({
            "pipeline": args.pipeline,
            "frames": args.batch,
            "window": win,
            "resolution": f"{args.width}x{args.height}",
            "frames_per_sec_per_chip": round(n_timed / dt, 2),
            "ms_per_frame": round(1000 * dt / max(n_timed, 1), 2),
            "keyframes": tracker.keyframe_count,
        }))
        return 0
    elif args.pipeline in ("tsdf", "tsdf-window"):
        # Dense frame-to-model frames/sec: KinectFusion loop over a
        # synthetic trajectory, per-frame dispatch ("tsdf") or --window
        # frames scanned per dispatch ("tsdf-window"). Honest timing by
        # construction (distinct frames; stats materialize per call).
        from realsensetracker_tpu.mapping.tsdf import TsdfConfig
        from realsensetracker_tpu.tracking.tsdf_tracker import TsdfTracker

        win = args.window if args.pipeline == "tsdf-window" else 0
        depths, _ = synthetic.render_trajectory(
            intr, args.batch, scene=synthetic.default_scene(seed=3),
            seed=0, step_scale=0.008,
        )
        frames = [np.asarray(depths[i]) for i in range(args.batch)]
        # c2f render (the production path) when the resolution allows it.
        coarse = 4 if (args.height % 4 == 0 and args.width % 4 == 0) else 1
        tracker = TsdfTracker(
            intr, volume=TsdfConfig(raycast_coarse=coarse)
        )

        def run(fr, base):
            ts = [float(base + i) / 30.0 for i in range(len(fr))]
            if win:
                tracker.process_window(fr, ts, window=win)
            else:
                for f, t in zip(fr, ts):
                    tracker.process(f, t)

        # Floor 2: the warmup must cover the seed frame AND the first
        # tracked step (its compile must not land in the timed region).
        skip = min(2 * max(win, 1), max(args.batch // 4, 2))
        run(frames[:skip], 0)  # warmup: seed + compile
        n_timed = args.batch - skip
        with traced():
            t0 = time.perf_counter()
            run(frames[skip:], skip)
            dt = time.perf_counter() - t0
        print(json.dumps({
            "pipeline": args.pipeline,
            "frames": args.batch,
            "window": win,
            "resolution": f"{args.width}x{args.height}",
            "volume": f"{tracker.volume.resolution}^3",
            "raycast_coarse": coarse,
            "frames_per_sec_per_chip": round(n_timed / dt, 2),
            "ms_per_frame": round(1000 * dt / max(n_timed, 1), 2),
        }))
        return 0
    else:
        raise SystemExit(f"unsupported pipeline for benchmarking: {args.pipeline}")

    # Single-device program: the per-chip rate IS the measured rate.
    print(json.dumps({
        "pipeline": args.pipeline,
        "batch": args.batch,
        "resolution": f"{args.width}x{args.height}",
        "pairs_per_sec_per_chip": round(per_pair, 2),
        "ms_per_batch": round(1000 * dt / args.iters, 2),
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
