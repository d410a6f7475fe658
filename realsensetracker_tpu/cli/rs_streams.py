"""rs-streams: concurrent multi-stream tracking demo (BASELINE config 5).

Tracks S independent depth streams in one compiled step per frame-tick
(parallel/streams.py) and reports aggregate and per-stream FPS -- the
"8 concurrent streams at 30 FPS each with live pose output" configuration.
`--rgb` switches every stream to the joint point-to-plane + photometric
objective (step_streams_masked_rgbd[_window]).

Usage:
  python -m realsensetracker_tpu.cli.rs_streams --streams 8 --frames 30
"""

from __future__ import annotations

import argparse
import time

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="rs-streams", description=__doc__)
    p.add_argument("--streams", type=int, default=8)
    p.add_argument("--frames", type=int, default=30)
    p.add_argument("--window", type=int, default=0,
                   help="scan W frames per dispatch (S x W frames advance "
                        "in ONE compiled step; 0 = one dispatch per frame)")
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--height", type=int, default=480)
    p.add_argument("--rgb", action="store_true",
                   help="RGB-D streams: joint point-to-plane + photometric "
                        "odometry per stream (parallel/streams "
                        "step_streams_masked_rgbd[_window])")
    p.add_argument("--tsdf", action="store_true",
                   help="dense streams: each slot is a KinectFusion "
                        "frame-to-model tracker with its own TSDF volume "
                        "(parallel/streams step_tsdf_streams[_window])")
    p.add_argument("--tsdf-resolution", type=int, default=128,
                   help="--tsdf: voxels per axis per stream volume "
                        "(device memory = streams * 2 * V^3 * 4 bytes)")
    p.add_argument("--tsdf-voxel", type=float, default=0.04,
                   help="--tsdf: voxel edge length in meters")
    p.add_argument("--print-poses", action="store_true")
    return p


def _slice_windows(frames, win: int) -> list:
    """(F, S, H, W) device frames -> pre-sliced full windows (S, W, H, W)."""
    import jax.numpy as jnp

    usable = ((frames.shape[0] - 1) // win) * win
    return [
        jnp.moveaxis(frames[1 + k : 1 + k + win], 0, 1)
        for k in range(0, usable, win)
    ]


class _DepthMode:
    """step_streams / step_streams_window over synthetic depth streams."""

    label = "streams"

    def __init__(self, args, intr):
        import jax.numpy as jnp

        from realsensetracker_tpu.data import synthetic
        from realsensetracker_tpu.parallel import streams

        self._jnp, self._streams, self._intr = jnp, streams, intr
        s = args.streams
        print(f"rendering {s} x {args.frames} synthetic frames ...")
        all_depths = []
        for i in range(s):
            scene = synthetic.default_scene(seed=40 + i)
            d, _ = synthetic.render_trajectory(
                intr, args.frames, scene=scene, seed=i, step_scale=0.01
            )
            all_depths.append(d)
        self.depths = jnp.stack(all_depths, axis=1)  # (F, S, H, W)
        self.state = streams.init_streams(self.depths[0], intr)

    def warm(self, win: int) -> None:
        # Warm up on a DISTINCT input (frame 0 vs itself), so the timed
        # steps never repeat the warm-up's inputs. Window inputs are pre-sliced here so the timed loop measures stepping,
        # not (F, S, ...) -> (S, W, ...) reshuffles.
        jnp, st = self._jnp, self._streams
        if win:
            self._windows = _slice_windows(self.depths, win)
            warm = jnp.repeat(self.depths[0][:, None], win, axis=1)
            state_w, _ = st.step_streams_window(self.state, warm, self._intr)
        else:
            state_w, _ = st.step_streams(self.state, self.depths[0],
                                         self._intr)
        np.asarray(state_w.poses)  # warmup fence (compile + execute)

    def step(self, f: int):
        self.state, res = self._streams.step_streams(
            self.state, self.depths[f], self._intr
        )
        return res

    def step_window(self, k: int, win: int) -> list:
        self.state, res = self._streams.step_streams_window(
            self.state, self._windows[k // win], self._intr
        )
        # Unstack (S, W, ...) window results into per-frame records.
        return [
            self._streams.StreamStepResult(*(x[:, j] for x in res))
            for j in range(win)
        ]

    @staticmethod
    def success_of(rec) -> np.ndarray:
        return np.asarray(rec.success)

    @staticmethod
    def poses_of(rec) -> np.ndarray:
        return np.asarray(rec.poses)


class _RgbdMode:
    """Masked RGB-D steps over synthetic depth+intensity streams; records
    are (S, MASKED_RGBD_STATS_WIDTH) stats rows."""

    label = "RGB-D streams"

    def __init__(self, args, intr):
        import jax.numpy as jnp

        from realsensetracker_tpu.data import synthetic
        from realsensetracker_tpu.parallel import streams

        self._jnp, self._streams, self._intr = jnp, streams, intr
        s = args.streams
        print(f"rendering {s} x {args.frames} synthetic RGB-D frames ...")
        all_d, all_g = [], []
        for i in range(s):
            scene = synthetic.default_scene(seed=40 + i)
            d, c, _ = synthetic.render_trajectory_rgbd(
                intr, args.frames, scene=scene, seed=i, step_scale=0.01
            )
            all_d.append(d)
            all_g.append(synthetic.intensity_from_rgb(c))
        self.depths = jnp.stack(all_d, axis=1)  # (F, S, H, W)
        self.grays = jnp.stack(all_g, axis=1)
        self._ones = jnp.ones((s,), bool)
        self._zeros = jnp.zeros((s,), bool)
        self.state = streams.blank_streams_rgbd(intr, num_streams=s)

    def warm(self, win: int) -> None:
        # Seeding on frame 0 doubles as the single-step compile + warmup
        # (distinct from every timed frame).
        jnp, st = self._jnp, self._streams
        self.state, _ = st.step_streams_masked_rgbd(
            self.state, self.depths[0], self.grays[0], self._ones,
            self._ones, self._intr,
        )
        np.asarray(self.state.poses)  # warmup fence
        if win:
            s = self.depths.shape[1]
            self._aw = jnp.ones((s, win), bool)
            self._sw = jnp.zeros((s, win), bool)
            self._dwin = _slice_windows(self.depths, win)
            self._gwin = _slice_windows(self.grays, win)
            warm_d = jnp.repeat(self.depths[0][:, None], win, axis=1)
            warm_g = jnp.repeat(self.grays[0][:, None], win, axis=1)
            st_w, _ = st.step_streams_masked_rgbd_window(
                self.state, warm_d, warm_g, self._aw, self._sw, self._intr
            )
            np.asarray(st_w.poses)  # window-program warmup (discarded)

    def step(self, f: int):
        self.state, stats = self._streams.step_streams_masked_rgbd(
            self.state, self.depths[f], self.grays[f], self._ones,
            self._zeros, self._intr,
        )
        return stats

    def step_window(self, k: int, win: int) -> list:
        self.state, stats = self._streams.step_streams_masked_rgbd_window(
            self.state, self._dwin[k // win], self._gwin[k // win],
            self._aw, self._sw, self._intr,
        )
        return [stats[:, j] for j in range(win)]

    @staticmethod
    def success_of(rec) -> np.ndarray:
        return np.asarray(rec)[:, 32] > 0.5

    @staticmethod
    def poses_of(rec) -> np.ndarray:
        rec = np.asarray(rec)
        return rec[:, :16].reshape(len(rec), 4, 4)


class _TsdfMode:
    """Dense streams: S per-slot TSDF volumes advanced by
    step_tsdf_streams[_window]; records are StreamStepResult."""

    label = "dense (TSDF) streams"

    def __init__(self, args, intr):
        import jax.numpy as jnp

        from realsensetracker_tpu.data import synthetic
        from realsensetracker_tpu.mapping.tsdf import TsdfConfig
        from realsensetracker_tpu.parallel import streams

        self._jnp, self._streams, self._intr = jnp, streams, intr
        res, vox = args.tsdf_resolution, args.tsdf_voxel
        extent = res * vox
        self._cfg = TsdfConfig(
            resolution=res, voxel_size=vox,
            origin=(-extent / 2, -extent / 2, -0.109375 * extent),
            trunc=max(3.0 * vox, 0.1),
            raycast_coarse=4 if (intr.height % 4 == 0
                                 and intr.width % 4 == 0) else 1,
        )
        s = args.streams
        print(f"rendering {s} x {args.frames} synthetic frames "
              f"({res}^3 volume per stream) ...")
        all_depths = []
        for i in range(s):
            scene = synthetic.default_scene(seed=40 + i)
            d, _ = synthetic.render_trajectory(
                intr, args.frames, scene=scene, seed=i, step_scale=0.01
            )
            all_depths.append(d)
        self.depths = jnp.stack(all_depths, axis=1)  # (F, S, H, W)
        self.state = streams.init_tsdf_streams(
            self.depths[0], intr, self._cfg
        )

    def warm(self, win: int) -> None:
        jnp, st = self._jnp, self._streams
        if win:
            self._windows = _slice_windows(self.depths, win)
            warm = jnp.repeat(self.depths[0][:, None], win, axis=1)
            state_w, _ = st.step_tsdf_streams_window(
                self.state, warm, self._intr, self._cfg
            )
        else:
            state_w, _ = st.step_tsdf_streams(
                self.state, self.depths[0], self._intr, self._cfg
            )
        np.asarray(state_w.poses)  # warmup fence (compile + execute)

    def step(self, f: int):
        self.state, res = self._streams.step_tsdf_streams(
            self.state, self.depths[f], self._intr, self._cfg
        )
        return res

    def step_window(self, k: int, win: int) -> list:
        self.state, res = self._streams.step_tsdf_streams_window(
            self.state, self._windows[k // win], self._intr, self._cfg
        )
        return [
            self._streams.StreamStepResult(*(x[:, j] for x in res))
            for j in range(win)
        ]

    success_of = staticmethod(_DepthMode.success_of)
    poses_of = staticmethod(_DepthMode.poses_of)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from realsensetracker_tpu.utils.device import enable_compile_cache

    enable_compile_cache()
    import sys

    from realsensetracker_tpu.geometry import camera

    if args.rgb and args.tsdf:
        print("--rgb and --tsdf are mutually exclusive", file=sys.stderr)
        return 1
    intr = camera.Intrinsics(
        fx=args.width * 0.8, fy=args.width * 0.8,
        cx=(args.width - 1) / 2, cy=(args.height - 1) / 2,
        width=args.width, height=args.height,
    )
    s = args.streams
    mode_cls = (_RgbdMode if args.rgb
                else _TsdfMode if args.tsdf else _DepthMode)
    mode = mode_cls(args, intr)
    win = max(0, args.window)
    # The trailing (frames-1) % W steps fall back to per-frame stepping --
    # silently dropping them would misreport the run (and a short tail
    # window would cost its own compile).
    usable = ((args.frames - 1) // win) * win if win else 0
    mode.warm(win)

    # Per-frame host readbacks are expensive through remote-dispatch
    # runtimes: keep results on device during the timed loop and read the
    # log afterwards ("live pose output" = device-resident poses each tick).
    t0 = time.perf_counter()
    n_steps = 0
    results = []
    if win:
        for k in range(0, usable, win):
            results.extend(mode.step_window(k, win))
            n_steps += win
    for f in range(1 + usable, args.frames):
        results.append(mode.step(f))
        n_steps += 1
    # Host materialization is the timing fence: the run ends when the
    # final poses reach the host.
    np.asarray(mode.state.poses)
    dt = time.perf_counter() - t0
    for f, rec in enumerate(results, start=1):
        ok = int(mode.success_of(rec).sum())
        if args.print_poses:
            poses = mode.poses_of(rec)
            for i in range(s):
                t = poses[i][:3, 3]
                print(f"  frame {f} stream {i}: "
                      f"t=({t[0]:+.3f},{t[1]:+.3f},{t[2]:+.3f})")
        else:
            print(f"frame {f}: {ok}/{s} streams tracking")
    per_stream_fps = n_steps / dt
    print(
        f"{s} {mode.label} x {n_steps} steps in {dt:.2f}s: "
        f"{per_stream_fps:.1f} FPS/stream "
        f"({s * per_stream_fps:.0f} frames/s aggregate)"
    )
    target = 30.0
    print(f"config-5 target 30 FPS/stream: "
          f"{'MET' if per_stream_fps >= target else 'NOT MET'}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
