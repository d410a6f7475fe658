"""rs-tracker: continuous tracker demo on a hardware-free source.

Port of the rs_tracker prototype app (rs_tracker.cpp:33-116): a loop pulling
frames from a fake source (RandomSource in the reference, the raycast scene
here -- random clouds cannot be tracked meaningfully), registering
consecutive frames (GICP in the reference; selectable here), and printing
the pose as quaternion|translation like the reference's operator<<
(rs_tracker.cpp:28-31).

Usage:
  python -m realsensetracker_tpu.cli.rs_tracker --frames 20 --method gicp
"""

from __future__ import annotations

import argparse

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="rs-tracker", description=__doc__)
    p.add_argument("--frames", type=int, default=20)
    p.add_argument("--method", default="gicp",
                   choices=["projective", "keyframe", "icp", "gicp"])
    p.add_argument("--width", type=int, default=160)
    p.add_argument("--height", type=int, default=120)
    p.add_argument("--voxel-size", type=float, default=0.1)  # rs_tracker.cpp:79
    p.add_argument("--seed", type=int, default=0)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from realsensetracker_tpu.utils.device import enable_compile_cache

    enable_compile_cache()
    import jax.numpy as jnp

    from realsensetracker_tpu.api import Tracker, TrackerConfig
    from realsensetracker_tpu.data import synthetic
    from realsensetracker_tpu.geometry import camera, se3

    intr = camera.Intrinsics(
        fx=args.width * 0.8, fy=args.width * 0.8,
        cx=(args.width - 1) / 2, cy=(args.height - 1) / 2,
        width=args.width, height=args.height,
    )
    depths, _ = synthetic.render_trajectory(intr, args.frames, seed=args.seed)
    cfg = TrackerConfig(intrinsics=intr, method=args.method)
    cfg.align.voxel_size = args.voxel_size
    cfg.align.cloud_capacity = 4096
    cfg.gicp.max_outer = 8
    tracker = Tracker(cfg)

    for i in range(args.frames):
        res = tracker.process(depths[i], float(i))
        T = np.asarray(res.pose)
        q = np.asarray(se3.quaternion_from_matrix(jnp.asarray(T[:3, :3])))
        t = T[:3, 3]
        # Reference pose print format: quaternion | translation
        # (rs_tracker.cpp:28-31).
        print(f"frame {i:3d} [{'ok' if res.success else 'FAIL'}] "
              f"q=({q[0]:+.4f},{q[1]:+.4f},{q[2]:+.4f},{q[3]:+.4f}) | "
              f"t=({t[0]:+.4f},{t[1]:+.4f},{t[2]:+.4f})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
