"""rs-replay: offline tracking over a recorded clip or TUM sequence.

CLI port of rs_replay_app (rs_replay_app.cpp:159-415): glob/replay recorded
data, per-frame registration, pose accumulation, world-model growth, and
(new, required by the ATE metric) trajectory output + optional ATE report
against groundtruth.

Usage:
  python -m realsensetracker_tpu.cli.rs_replay --record clip.rsc \
      --trajectory-out traj.txt --method projective
  python -m realsensetracker_tpu.cli.rs_replay --tum /data/fr1_desk --ate
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="rs-replay", description=__doc__)
    p.add_argument("--record", "-r", default="", help="Input .rsc clip file")
    p.add_argument("--tum", default="", help="TUM sequence directory")
    p.add_argument(
        "--frame-interval", "-f", type=float, default=0.0,
        help="Frame interval in ms (reference default 1000; 0 = as fast as possible)",
    )
    p.add_argument("--method", default="projective",
                   choices=["projective", "rgbd", "keyframe", "model",
                            "tsdf", "icp", "gicp", "slam"])
    p.add_argument("--max-frames", type=int, default=0,
                   help="process at most this many frames (counted from "
                        "--start-frame); 0 = all")
    p.add_argument("--start-frame", type=int, default=0,
                   help="Skip this many frames first (with --resume-state: "
                        "continue exactly where the snapshot left off)")
    p.add_argument("--trajectory-out", default="")
    p.add_argument("--slam-prep-scale", type=int, default=0, metavar="S",
                   help="method=slam: build keyframe clouds from the "
                        "1/S pyramid level (power of 2) -- cuts the "
                        "keyframe-prep device cost ~S^2-fold (the "
                        "per-frame p90 tail); clouds change slightly, "
                        "so this is an explicit latency knob "
                        "(0 = full res)")
    p.add_argument("--slam-rgb", action="store_true",
                   help="SLAM only: use the joint geometric+photometric "
                        "RGB-D odometry (requires a color stream); loop "
                        "closure stays geometric")
    p.add_argument("--window", type=int, default=0, metavar="W",
                   help="slam/keyframe/tsdf methods (incl. --slam-rgb, "
                        "--tsdf-color): scan up to W frames per device "
                        "dispatch (amortizes the per-dispatch overhead; "
                        "identical trajectory to per-frame mode -- "
                        "slam/keyframe scans truncate at keyframe events)")
    p.add_argument("--optimize-every", type=int, default=0,
                   help="SLAM only: run pose-graph optimization in-stream "
                        "every N keyframes, feeding the correction back "
                        "into tracking (0 = only once at the end)")
    p.add_argument("--save-state", default="", metavar="NPZ",
                   help="slam: snapshot the tracker state (VO + keyframe "
                        "store + loop edges) after the run; tsdf: snapshot "
                        "pose + trajectory + dense volume")
    p.add_argument("--resume-state", default="", metavar="NPZ",
                   help="restore a --save-state snapshot before processing "
                        "frames (methods: slam, tsdf)")
    p.add_argument("--tsdf-color", action="store_true",
                   help="method=tsdf: fuse per-voxel RGB from the color "
                        "stream (colored --save-map export)")
    p.add_argument("--tsdf-photometric", action="store_true",
                   help="method=tsdf (with --tsdf-color): joint geometric"
                        " + photometric frame-to-model registration -- "
                        "pins in-plane motion on geometry-degenerate "
                        "scenes (photometric KinectFusion)")
    p.add_argument("--tsdf-resolution", type=int, default=0, metavar="V",
                   help="method=tsdf: voxels per axis (0 = default 128); "
                        "a resumed run must match its snapshot")
    p.add_argument("--tsdf-voxel", type=float, default=0.0, metavar="M",
                   help="method=tsdf: voxel edge length in meters "
                        "(0 = default 0.04); the volume stays centered")
    p.add_argument("--tsdf-track-scale", type=int, default=0, metavar="S",
                   help="method=tsdf: register each frame against a "
                        "model render at 1/S resolution (power of 2; "
                        "integration stays full-res, so map quality is "
                        "unchanged) -- cuts the raycast-dominated "
                        "tracked-step cost ~S^2-fold (0 = full res)")
    p.add_argument("--tsdf-track-scale-fallback", type=float, default=0.0,
                   metavar="C",
                   help="method=tsdf with --tsdf-track-scale: constraint-"
                        "coverage floor (valid render px / valid frame px "
                        "at the tracking resolution) below which the "
                        "tracker auto-falls-back to full-resolution "
                        "registration -- the safety net for scenes whose "
                        "structures vanish from the reduced render "
                        "(0 = off)")
    p.add_argument("--tsdf-integrate-every", type=int, default=0,
                   metavar="N",
                   help="method=tsdf: fuse every Nth tracked frame "
                        "(KinectFusion integrate decimation; pose still "
                        "solves every frame) -- divides the ~47 ms "
                        "full-res integrate floor by N (0/1 = every "
                        "frame)")
    p.add_argument("--tsdf-integrate-slab", type=int, default=0,
                   metavar="S",
                   help="method=tsdf: frustum-restricted integration -- "
                        "update only a dynamic S^3 sub-grid positioned "
                        "over each frame's observed AABB ((V/S)^3-fold "
                        "fewer depth gathers; bit-identical fusion, with "
                        "an automatic full-volume fallback when the AABB "
                        "does not fit; 0 = full volume)")
    p.add_argument("--submap-radius", type=float, default=0.0, metavar="M",
                   help="method=tsdf: > 0 enables the submap atlas "
                        "(unbounded dense mapping from fixed-shape "
                        "volumes): spawn a new volume every M meters of "
                        "camera/view-center drift; 0 = single volume")
    p.add_argument("--optimize-atlas", action="store_true",
                   help="with --submap-radius: loop-close and pose-graph-"
                        "optimize the submap anchors after the run (the "
                        "dense world model moves rigidly -- no re-fusion); "
                        "applies before --save-map/--save-mesh/--ate")
    p.add_argument("--save-map", default="", metavar="PLY",
                   help="export the final world map as a PLY point cloud "
                        "(methods with a map: model, tsdf; colored with "
                        "--tsdf-color)")
    p.add_argument("--map-normals", action="store_true",
                   help="method=tsdf --save-map: export TSDF-gradient "
                        "normals per point (oriented PLY)")
    p.add_argument("--save-mesh", default="", metavar="PLY",
                   help="export the dense surface as a welded PLY TRIANGLE "
                        "mesh (marching tetrahedra). method=tsdf: the live "
                        "fused volume (per-vertex color with --tsdf-color); "
                        "method=slam: keyframe depths re-fused at the "
                        "loop-optimized poses (auto-sized volume)")
    p.add_argument("--map-capacity", type=int, default=0)
    p.add_argument("--render-dir", default="", help="Write per-frame model PNGs here")
    p.add_argument("--ate", action="store_true", help="Report ATE vs groundtruth (TUM)")
    p.add_argument("--rpe", type=float, default=0.0, metavar="DELTA_S",
                   help="Report RPE (drift over DELTA_S-second windows) vs "
                        "groundtruth (TUM)")
    p.add_argument("--json", action="store_true", help="Machine-readable per-frame output")
    p.add_argument("--serve", type=int, default=-1, metavar="PORT",
                   help="Serve a live view of the tracked sequence over "
                        "HTTP while replaying (0 = auto port): latest depth "
                        "frame + pose/rmse status, self-refreshing page")
    p.add_argument("--live-latest", default="", metavar="PNG",
                   help="Atomically refresh this PNG with the latest frame")
    return p


def _stop(args) -> int | None:
    """End index from --start-frame + --max-frames (a COUNT, not an
    absolute index: --start-frame 100 --max-frames 50 means frames
    100..149, not an empty range)."""
    return (args.start_frame + args.max_frames) if args.max_frames else None


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from realsensetracker_tpu.utils.device import enable_compile_cache

    enable_compile_cache()
    from realsensetracker_tpu.api import Tracker, TrackerConfig
    from realsensetracker_tpu.data import recorded, stream as stream_mod

    if args.slam_rgb and args.method != "slam":
        print("--slam-rgb requires --method slam", file=sys.stderr)
        return 1
    if args.window > 0 and args.method not in ("slam", "keyframe", "tsdf"):
        print("--window requires --method slam, keyframe, or tsdf",
              file=sys.stderr)
        return 1
    if args.tsdf_photometric and not args.tsdf_color:
        print("--tsdf-photometric requires --tsdf-color", file=sys.stderr)
        return 1
    if args.tsdf_color and args.method != "tsdf":
        print("--tsdf-color requires --method tsdf", file=sys.stderr)
        return 1
    if (args.tsdf_resolution or args.tsdf_voxel or args.tsdf_track_scale
            or args.tsdf_integrate_every or args.tsdf_integrate_slab
            or args.tsdf_track_scale_fallback) and args.method != "tsdf":
        print("--tsdf-resolution/--tsdf-voxel/--tsdf-track-scale/"
              "--tsdf-integrate-every/--tsdf-integrate-slab/"
              "--tsdf-track-scale-fallback require "
              "--method tsdf", file=sys.stderr)
        return 1
    if args.tsdf_track_scale_fallback and not args.tsdf_track_scale:
        print("--tsdf-track-scale-fallback requires --tsdf-track-scale",
              file=sys.stderr)
        return 1
    wants_color = args.method == "rgbd" or args.slam_rgb or args.tsdf_color

    gt = None
    depth_scale = None  # set when frames are raw integer counts
    if args.tum:
        from realsensetracker_tpu.data import tum

        seq = tum.TumSequence.open(args.tum)
        if not len(seq):
            print(f"no depth frames in {args.tum}", file=sys.stderr)
            return 1
        first = seq.depth(0)
        h, w = first.shape
        from realsensetracker_tpu.geometry import camera

        intr = camera.TUM_FR1 if (w, h) == (640, 480) else camera.Intrinsics(
            fx=w * 0.8, fy=w * 0.8, cx=(w - 1) / 2, cy=(h - 1) / 2, width=w, height=h
        )
        if wants_color:
            if not seq.rgb_index:
                print(f"{args.tum}: no rgb.txt (required by --method rgbd "
                      "/ --slam-rgb)", file=sys.stderr)
                return 1
            if args.tsdf_color:
                # Full RGB (the volume fuses color), not the luma plane
                # frames_rgbd yields for the photometric term.
                stop_i = min(_stop(args) or len(seq), len(seq))
                frames = (
                    (seq.depth_index[i][0], seq.depth(i),
                     seq.rgb_for_depth(i))
                    for i in range(args.start_frame, stop_i)
                )
            else:
                frames = (
                    (ts, d, g)
                    for ts, d, g in seq.frames_rgbd(start=args.start_frame,
                                                    stop=_stop(args))
                )
        else:
            # Depth-only replay streams RAW uint16 frames: half the
            # host->device upload bytes (the upload rides the timed
            # dispatch on windowed paths); the trackers convert to meters
            # on device
            # (depth_scale below; SLAM's host-side logic converts lazily
            # at keyframe/relocalization events only).
            frames = stream_mod.stream_tum(seq, stop=_stop(args),
                                           start=args.start_frame, raw=True)
            depth_scale = 1.0 / tum.DEPTH_SCALE
        if (args.ate or args.rpe > 0) and seq.groundtruth:
            gt = seq.groundtruth_trajectory()
    elif args.record:
        clip = recorded.read_clip(args.record)
        intr = clip.intrinsics
        stop = min(_stop(args) or len(clip), len(clip))
        start = args.start_frame
        if wants_color:
            if not clip.has_color:
                print(f"{args.record}: depth-only clip (record with "
                      "rs-viewer --color for --method rgbd / --slam-rgb)",
                      file=sys.stderr)
                return 1
            frames = ((clip.timestamps[i], clip.depths[i],
                       clip.colors[i] if args.tsdf_color else clip.gray(i))
                      for i in range(start, stop))
        else:
            frames = ((clip.timestamps[i], clip.depths[i]) for i in range(start, stop))
    else:
        print("need --record or --tum", file=sys.stderr)
        return 1

    if args.method == "slam":
        from realsensetracker_tpu.tracking.slam import SlamConfig, SlamTracker

        slam_kw = {}
        if depth_scale is not None:
            slam_kw["depth_scale"] = depth_scale
        if args.slam_prep_scale > 1:
            slam_kw["keyframe_prep_scale"] = args.slam_prep_scale
        tracker = SlamTracker(
            SlamConfig(intrinsics=intr, optimize_every=args.optimize_every,
                       use_rgb=args.slam_rgb,
                       # Dense re-fusion after optimization needs the raw
                       # keyframe depths kept on host.
                       keep_depths=bool(args.save_mesh), **slam_kw)
        )
        if args.resume_state:
            from realsensetracker_tpu.tracking import checkpoint

            checkpoint.load_slam(args.resume_state, tracker)
            print(f"resumed {tracker.keyframe_count} keyframes, "
                  f"{len(tracker.trajectory)} frames from {args.resume_state}")
    else:
        if (args.resume_state or args.save_state) and args.method != "tsdf":
            print("--save-state/--resume-state require --method slam or tsdf",
                  file=sys.stderr)
            return 1
        if args.submap_radius and args.method != "tsdf":
            print("--submap-radius requires --method tsdf", file=sys.stderr)
            return 1
        if args.optimize_atlas and not args.submap_radius:
            print("--optimize-atlas requires --submap-radius",
                  file=sys.stderr)
            return 1
        tsdf_kw = {}
        if args.method == "tsdf" and (args.tsdf_resolution or args.tsdf_voxel
                                      or args.tsdf_track_scale
                                      or args.tsdf_integrate_every
                                      or args.tsdf_integrate_slab):
            from realsensetracker_tpu.mapping.tsdf import sized_config

            cfg_tsdf = sized_config(args.tsdf_resolution, args.tsdf_voxel)
            if args.tsdf_track_scale:
                cfg_tsdf = cfg_tsdf._replace(
                    track_scale=args.tsdf_track_scale
                )
            if args.tsdf_integrate_every > 1:
                cfg_tsdf = cfg_tsdf._replace(
                    integrate_every=args.tsdf_integrate_every
                )
            if args.tsdf_integrate_slab:
                cfg_tsdf = cfg_tsdf._replace(
                    integrate_slab=args.tsdf_integrate_slab
                )
            tsdf_kw["tsdf"] = cfg_tsdf
        if args.tsdf_track_scale_fallback:
            tsdf_kw["tsdf_track_scale_fallback"] = \
                args.tsdf_track_scale_fallback
        if depth_scale is not None:
            tsdf_kw["depth_scale"] = depth_scale
        cfg = TrackerConfig(intrinsics=intr, method=args.method,
                            map_capacity=args.map_capacity,
                            tsdf_color=args.tsdf_color,
                            tsdf_photometric=args.tsdf_photometric,
                            tsdf_submap_radius=args.submap_radius,
                            **tsdf_kw)
        tracker = Tracker(cfg)
        if args.resume_state:
            from realsensetracker_tpu.tracking import checkpoint

            if args.submap_radius:
                checkpoint.load_submaps(args.resume_state, tracker)
                print(f"resumed frame {tracker._impl._t._index}, "
                      f"{tracker._impl.num_submaps} submaps, "
                      f"{len(tracker.trajectory)} poses from "
                      f"{args.resume_state}")
            else:
                checkpoint.load_tsdf(args.resume_state, tracker)
                print(f"resumed frame {tracker._impl._index}, "
                      f"{len(tracker.trajectory)} poses from "
                      f"{args.resume_state}")

    server = None
    if args.serve >= 0 or args.live_latest:
        from realsensetracker_tpu.vis import live as live_mod

        if args.serve >= 0:
            server = live_mod.LiveServer(port=args.serve)
            print(f"live view: http://127.0.0.1:{server.port}/")

    def per_frame_results():
        for item in frames:
            t_frame = time.perf_counter()
            if wants_color:
                ts, depth, gray = item
                if gray is None:
                    print(f"t={ts:.3f}: no associated rgb frame, skipping",
                          file=sys.stderr)
                    continue
                if args.slam_rgb:
                    res = tracker.process(depth, ts, gray=gray)
                else:
                    res = tracker.process(depth, ts, color=gray)
            else:
                ts, depth = item
                res = tracker.process(depth, ts)
            import numpy as np

            # Materialize INSIDE the timed window: the per-frame latency
            # counts until the pose reaches the host.
            np.asarray(res.pose)
            yield ts, depth, res, (time.perf_counter() - t_frame) * 1000.0

    def windowed_results():
        # One scanned dispatch per window (truncated at keyframe events
        # inside process_window); ms is amortized over the window's frames.
        buf = []

        def flush():
            t0 = time.perf_counter()
            kw = {"window": args.window}
            if wants_color:
                kw["grays"] = [g for _, _, g in buf]
            res_list = tracker.process_window(
                [b[1] for b in buf], [b[0] for b in buf], **kw
            )
            ms = (time.perf_counter() - t0) * 1000.0 / max(len(buf), 1)
            for b, res in zip(buf, res_list):
                yield b[0], b[1], res, ms
            buf.clear()

        for item in frames:
            if wants_color and item[2] is None:
                print(f"t={item[0]:.3f}: no associated rgb frame, skipping",
                      file=sys.stderr)
                continue
            buf.append(item)
            if len(buf) >= args.window:
                yield from flush()
        if buf:
            yield from flush()

    from realsensetracker_tpu.data.depth_units import to_meters_np

    def _meters(d):
        """Raw integer frames -> f32 meters for host-side consumers
        (viewer PNG, orbit unprojection); float frames pass through."""
        return to_meters_np(d, depth_scale or 1.0)

    n = 0
    t_start = time.perf_counter()
    for ts, depth, res, frame_ms in (
        windowed_results() if args.window > 0 else per_frame_results()
    ):
        import numpy as np

        pose_np = np.asarray(res.pose)
        if args.json:
            print(json.dumps({
                "frame": res.frame_index,
                "timestamp": ts,
                "success": bool(res.success),
                "rmse": float(res.rmse),
                "inliers": float(res.inlier_fraction),
                "ms": round(frame_ms, 2),
                "kf": bool(getattr(res, "is_new_keyframe", False)),
                "pose": pose_np.reshape(-1).round(6).tolist(),
            }))
        else:
            tag = "ok" if res.success else "ALIGNMENT FAILED"
            print(f"frame {res.frame_index:4d} t={ts:.3f} [{tag}] "
                  f"rmse={res.rmse:.4f} inliers={res.inlier_fraction:.2f}")
        if server is not None or args.live_latest:
            import numpy as np

            from realsensetracker_tpu.vis import live as live_mod

            png = live_mod.encode_png(live_mod.depth_to_rgb(_meters(depth)))
            status = {
                "frame": res.frame_index,
                "timestamp": float(ts),
                "success": bool(res.success),
                "rmse": round(float(res.rmse), 5),
                "position": np.asarray(res.pose)[:3, 3].round(4).tolist(),
                "fps": round((n + 1) / max(time.perf_counter() - t_start, 1e-6), 2),
            }
            if server is not None:
                server.update(png, status)
                # Feed the /orbit 3-D view every few frames: subsampled
                # world map when the method grows one (--map-capacity /
                # tsdf), else the current frame unprojected at its
                # tracked pose, plus the camera trail either way.
                if n % 10 == 0:
                    m = getattr(tracker, "world_map", None)
                    if m is not None:
                        pts = np.asarray(m.points)[np.asarray(m.mask)]
                    else:
                        # Host-NumPy unprojection: this is viewer
                        # decoration on the TIMED replay path -- a jnp
                        # call here would pay a compile per shape plus a
                        # dispatch and a full-frame device round-trip for
                        # ~1 ms of broadcasting.
                        d = _meters(depth).astype(np.float32)
                        h_, w_ = d.shape
                        us = (np.arange(w_, dtype=np.float32) - intr.cx) \
                            / intr.fx
                        vs = (np.arange(h_, dtype=np.float32) - intr.cy) \
                            / intr.fy
                        local = np.stack(
                            [d * us[None, :], d * vs[:, None], d], axis=-1
                        ).reshape(-1, 3)[d.reshape(-1) > 0]
                        pts = local @ pose_np[:3, :3].T + pose_np[:3, 3]
                    if pts.shape[0] > 60000:
                        sel = np.random.RandomState(0).choice(
                            pts.shape[0], 60000, replace=False
                        )
                        pts = pts[sel]
                    trail = np.stack(
                        [np.asarray(p)[:3, 3] for p in tracker.trajectory.poses]
                    ) if len(tracker.trajectory) else None
                    server.update_cloud(pts.astype(np.float32), trajectory=trail)
            if args.live_latest:
                live_mod.write_latest_png(args.live_latest, png)
        if args.render_dir and getattr(tracker, "world_map", None) is not None:
            import os

            import numpy as np

            from realsensetracker_tpu.vis import render_cloud_png

            m = tracker.world_map
            pts = np.asarray(m.points)[np.asarray(m.mask)]
            render_cloud_png(os.path.join(args.render_dir, f"model_{n:04d}.png"),
                             [(pts, "gray")])
        if args.frame_interval > 0:
            time.sleep(args.frame_interval / 1000.0)
        n += 1
    dt = time.perf_counter() - t_start
    print(f"processed {n} frames in {dt:.2f}s ({n / max(dt, 1e-9):.1f} fps)")
    if args.submap_radius:
        print(f"submaps={tracker._impl.num_submaps} "
              f"(spawn radius {args.submap_radius} m)")
        if args.optimize_atlas:
            from realsensetracker_tpu.mapping.submaps import optimize_atlas

            loops = optimize_atlas(tracker._impl)
            print(f"atlas optimized: {loops} loop edges")

    if args.method == "slam":
        opt = tracker.optimize()
        print(f"keyframes={tracker.keyframe_count} "
              f"loop_closures={tracker.num_loop_closures} "
              f"relocalizations={tracker.num_relocalizations} "
              f"online_optimizations={tracker.num_online_optimizations} "
              f"optimized={'yes' if opt is not None else 'no'}")
        if args.save_state:
            from realsensetracker_tpu.tracking import checkpoint

            checkpoint.save_slam(args.save_state, tracker)
            print(f"state -> {args.save_state}")
    elif args.method == "tsdf" and args.save_state:
        from realsensetracker_tpu.tracking import checkpoint

        if args.submap_radius:
            checkpoint.save_submaps(args.save_state, tracker)
        else:
            checkpoint.save_tsdf(args.save_state, tracker)
        print(f"state -> {args.save_state}")

    if args.save_map:
        import numpy as np

        from realsensetracker_tpu.vis.render import export_ply

        m = getattr(tracker, "world_map", None)
        if m is None:
            print("--save-map: this method has no world map", file=sys.stderr)
        else:
            colors = normals = None
            if args.tsdf_color:
                cm = tracker.world_map_colored
                if cm is not None:
                    m, colors = cm
                    colors = np.asarray(colors)[np.asarray(m.mask)]
            elif args.map_normals:
                om = getattr(tracker, "world_map_oriented", None)
                if om is None:
                    print("--map-normals: this method has no oriented map "
                          "(use --method tsdf)", file=sys.stderr)
                else:
                    m, normals = om
                    normals = np.asarray(normals)[np.asarray(m.mask)]
            pts = np.asarray(m.points)[np.asarray(m.mask)]
            export_ply(args.save_map, pts, colors, normals=normals)
            tags = "".join([
                ", colored" if colors is not None else "",
                ", oriented" if normals is not None else "",
            ])
            print(f"map ({len(pts)} pts{tags}) -> {args.save_map}")

    if args.save_mesh:
        import numpy as np

        from realsensetracker_tpu.vis.render import export_mesh_ply

        mesh_fn = getattr(tracker, "world_mesh", None)
        try:
            mesh = mesh_fn() if mesh_fn is not None else None
        except ValueError as e:
            # e.g. a resumed SLAM state whose keyframes carry no depths
            print(f"--save-mesh: {e}", file=sys.stderr)
            mesh = None
        if mesh is None:
            print("--save-mesh: this method has no dense model "
                  "(use --method tsdf or slam)", file=sys.stderr)
        else:
            keep = np.asarray(mesh.mask)
            tris = np.asarray(mesh.vertices)[keep]
            cols = (
                np.asarray(mesh.colors)[keep]
                if mesh.colors is not None else None
            )
            export_mesh_ply(args.save_mesh, tris, cols)
            print(f"mesh ({len(tris)} triangles"
                  f"{', colored' if cols is not None else ''}) "
                  f"-> {args.save_mesh}")

    if args.trajectory_out:
        tracker.trajectory.save_tum(args.trajectory_out)
        print(f"trajectory -> {args.trajectory_out}")
    if gt is not None:
        from realsensetracker_tpu.tracking.trajectory import (
            absolute_trajectory_error,
            relative_pose_error,
        )

        if args.ate:
            ate = absolute_trajectory_error(tracker.trajectory, gt)
            print("ATE:", json.dumps(ate))
        if args.rpe > 0:
            rpe = relative_pose_error(tracker.trajectory, gt, delta=args.rpe)
            print("RPE:", json.dumps(rpe))
    if server is not None:
        server.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
