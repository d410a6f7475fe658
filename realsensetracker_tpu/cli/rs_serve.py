"""rs-serve: run the tracking service (POST depth frames -> SE(3) poses).

Production-deployment analog of the reference's always-live process
(rs_replay_app.cpp:159-415 runs an in-process loop; a deployment runs a
service): a long-lived HTTP endpoint holding one tracker. See
api/service.py for the protocol; the client side is
`realsensetracker_tpu.api.service.post_frame` (one frame per request) or
`post_window` (a frame batch to /track_window, scanned W frames per device
dispatch). `GET /metrics` exposes Prometheus counters/latency quantiles.

Usage:
  python -m realsensetracker_tpu.cli.rs_serve --method keyframe --port 8080
  # then from any producer:
  #   from realsensetracker_tpu.api.service import post_frame
  #   post_frame("http://host:8080", depth_f32_hw, ts)
"""

from __future__ import annotations

import argparse
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="rs-serve", description=__doc__)
    p.add_argument("--method", default="keyframe",
                   choices=["projective", "keyframe", "rgbd", "model",
                            "tsdf", "icp", "gicp", "slam"])
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=0, help="0 = auto")
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--height", type=int, default=480)
    p.add_argument("--fx", type=float, default=0.0,
                   help="focal length (default 0.8 * width)")
    p.add_argument("--fy", type=float, default=0.0)
    p.add_argument("--tsdf-resolution", type=int, default=0, metavar="V",
                   help="--method tsdf: volume resolution (voxels/axis, "
                        "0 = default 128); device/host RAM per session scales "
                        "as V^3")
    p.add_argument("--tsdf-voxel", type=float, default=0.0, metavar="M",
                   help="--method tsdf: voxel size in meters (0 = default "
                        "0.04)")
    p.add_argument("--tsdf-track-scale", type=int, default=0, metavar="S",
                   help="--method tsdf: register against a model render "
                        "at 1/S resolution (power of 2; integration stays "
                        "full-res) -- cuts the per-frame raycast cost "
                        "~S^2-fold (0 = full res)")
    p.add_argument("--tsdf-integrate-every", type=int, default=0,
                   metavar="N",
                   help="--method tsdf: fuse every Nth tracked frame per "
                        "session (KinectFusion integrate decimation; pose "
                        "still solves every frame). NOTE: the batched "
                        "(vmapped) executor computes-and-masks the "
                        "integrate, so this changes map semantics only; "
                        "serialized sessions also save its cost "
                        "(0/1 = every frame)")
    p.add_argument("--tsdf-integrate-slab", type=int, default=0,
                   metavar="S",
                   help="--method tsdf: frustum-restricted integration "
                        "over a dynamic S^3 sub-grid (bit-identical "
                        "fusion, automatic full-volume fallback). NOTE: "
                        "like --tsdf-integrate-every, the batched "
                        "executor computes both cond branches under "
                        "vmap; the win is serialized sessions "
                        "(0 = full volume)")
    p.add_argument("--tsdf-submap-radius", type=float, default=0.0,
                   metavar="M",
                   help="--batched --method tsdf: unbounded session extent "
                        "-- reseed a session's volume (anchor-composed "
                        "poses) when it drifts M meters from its last "
                        "seed; 0 = fixed volume")
    p.add_argument("--max-frames", type=int, default=0,
                   help="exit after this many tracked frames (0 = serve "
                        "forever); used by tests/smoke runs")
    p.add_argument("--batched", action="store_true",
                   help="cross-session dynamic batching: concurrent "
                        "sessions' /track frames coalesce into ONE device "
                        "dispatch (frame-to-frame odometry semantics; see "
                        "api/batching.py). --method rgbd switches slots to "
                        "joint depth+photometric odometry (frames must "
                        "carry color); --method tsdf gives every session "
                        "its own dense frame-to-model volume; other "
                        "--method values are ignored.")
    p.add_argument("--batch-capacity", type=int, default=8,
                   help="max concurrent sessions under --batched")
    p.add_argument("--batch-linger-ms", type=float, default=0.0,
                   help="wait this long for co-arriving requests before "
                        "dispatching a batch (0: the dispatch itself is "
                        "the batching window)")
    p.add_argument("--batch-mesh", type=int, default=0,
                   help="shard the --batched slot axis over this many "
                        "devices (0 = single device); capacity must be a "
                        "multiple of it")
    p.add_argument("--depth-scale", type=float, default=1e-3,
                   help="meters per raw unit for INTEGER depth frames "
                        "(clients may POST raw uint16 at half the f32 "
                        "bytes; RealSense Z16 default 1 mm, TUM PNGs "
                        "1/5000=2e-4). Float frames are always meters.")
    p.add_argument("--batch-window", type=int, default=1,
                   help="max frames per request under --batched: "
                        "/track_window batches scan up to this many frames "
                        "per slot inside the shared dispatch (second "
                        "compiled program; 1 = per-frame only)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from realsensetracker_tpu.utils.device import enable_compile_cache

    enable_compile_cache()
    from realsensetracker_tpu.api.service import TrackingService
    from realsensetracker_tpu.geometry import camera

    intr = camera.Intrinsics(
        fx=args.fx or args.width * 0.8,
        fy=args.fy or args.fx or args.width * 0.8,
        cx=(args.width - 1) / 2, cy=(args.height - 1) / 2,
        width=args.width, height=args.height,
    )

    if args.tsdf_submap_radius and not (args.batched
                                        and args.method == "tsdf"):
        import sys

        print("--tsdf-submap-radius requires --batched --method tsdf",
              file=sys.stderr)
        return 1
    tsdf_cfg = None
    if (args.tsdf_resolution or args.tsdf_voxel or args.tsdf_track_scale
            or args.tsdf_integrate_every or args.tsdf_integrate_slab):
        if args.method != "tsdf":
            import sys

            print("--tsdf-resolution/--tsdf-voxel/--tsdf-track-scale/"
                  "--tsdf-integrate-every/--tsdf-integrate-slab require "
                  "--method tsdf",
                  file=sys.stderr)
            return 1
        from realsensetracker_tpu.mapping.tsdf import sized_config

        tsdf_cfg = sized_config(args.tsdf_resolution, args.tsdf_voxel)
        if args.tsdf_track_scale:
            tsdf_cfg = tsdf_cfg._replace(track_scale=args.tsdf_track_scale)
        if args.tsdf_integrate_every > 1:
            tsdf_cfg = tsdf_cfg._replace(
                integrate_every=args.tsdf_integrate_every
            )
        if args.tsdf_integrate_slab:
            tsdf_cfg = tsdf_cfg._replace(
                integrate_slab=args.tsdf_integrate_slab
            )

    def make_tracker():
        if args.method == "slam":
            from realsensetracker_tpu.tracking.slam import SlamConfig, SlamTracker

            # depth_scale must match the service's: raw u16 bodies pass
            # through to SLAM (accepts_raw_depth) and convert at the
            # TRACKER's scale; the service's mismatch guard would
            # otherwise drop serving back to host-converted f32 uploads.
            return SlamTracker(SlamConfig(intrinsics=intr,
                                          depth_scale=args.depth_scale))
        from realsensetracker_tpu.api import Tracker, TrackerConfig

        tsdf_kw = {"tsdf": tsdf_cfg} if tsdf_cfg is not None else {}
        return Tracker(TrackerConfig(intrinsics=intr, method=args.method,
                                     depth_scale=args.depth_scale,
                                     **tsdf_kw))

    executor = None
    extra_status = None
    if args.batched:
        from realsensetracker_tpu.api.batching import (
            BatchedExecutor,
            BatchingConfig,
        )

        batch_mesh = None
        if args.batch_mesh:
            from realsensetracker_tpu.parallel import mesh as mesh_mod

            batch_mesh = mesh_mod.make_mesh(args.batch_mesh)
        executor = BatchedExecutor(BatchingConfig(
            intrinsics=intr,
            capacity=args.batch_capacity,
            linger_ms=args.batch_linger_ms,
            mesh=batch_mesh,
            window=args.batch_window,
            rgbd=args.method == "rgbd",
            tsdf=args.method == "tsdf",
            tsdf_cfg=tsdf_cfg,
            tsdf_submap_radius=args.tsdf_submap_radius,
            depth_scale=args.depth_scale,
        ))
        make_tracker = executor.make_session_tracker
        extra_status = executor.stats

    svc = TrackingService(
        make_tracker, host=args.host, port=args.port,
        max_frames=args.max_frames or None, extra_status=extra_status,
        depth_scale=args.depth_scale,
    )
    if args.batched:
        mode = ("batched-rgbd" if args.method == "rgbd"
                else "batched-tsdf" if args.method == "tsdf"
                else "batched")
    else:
        mode = args.method
    print(f"tracking service ({mode}, {args.width}x{args.height}) "
          f"on http://{args.host}:{svc.port}/  -- POST /track", flush=True)
    try:
        if args.max_frames:
            svc.done.wait()
        else:
            while True:
                time.sleep(3600)
    except KeyboardInterrupt:
        pass
    finally:
        svc.close()
        if executor is not None:
            executor.close()
    print(f"served {svc.status()['frames']} frames")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
