"""rs-capture: grab frames from a source and export point clouds as PLY.

Port of basic_capture (basic_capture.cpp:8-53): N frames -> /tmp/%04d.ply.
The camera is replaced by the synthetic scene or an existing clip.

Usage:
  python -m realsensetracker_tpu.cli.capture --frames 10 --out "/tmp/{:04d}.ply"
"""

from __future__ import annotations

import argparse

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="rs-capture", description=__doc__)
    p.add_argument("--frames", type=int, default=100)  # basic_capture.cpp:32
    p.add_argument("--out", default="/tmp/{:04d}.ply")  # :45
    p.add_argument("--clip", default="", help="Use clip frames instead of synthetic")
    p.add_argument("--seed", type=int, default=0)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from realsensetracker_tpu.utils.device import enable_compile_cache

    enable_compile_cache()
    import jax.numpy as jnp

    from realsensetracker_tpu.geometry import camera
    from realsensetracker_tpu.ops.pyramid import build_pyramid
    from realsensetracker_tpu.vis import export_ply

    if args.clip:
        from realsensetracker_tpu.data import recorded

        clip = recorded.read_clip(args.clip)
        intr = clip.intrinsics
        depths = clip.depths[: args.frames]
    else:
        from realsensetracker_tpu.data import synthetic

        intr = camera.TUM_DEFAULT
        depths, _ = synthetic.render_trajectory(intr, args.frames, seed=args.seed)
        depths = np.asarray(depths)

    for i in range(len(depths)):
        # No normals: only vertex_map/vertex_valid are read below.
        levels, _ = build_pyramid(jnp.asarray(depths[i]), intr, 1,
                                  with_normals=False)
        h, w = levels[0].vertex_valid.shape
        pts = np.asarray(levels[0].vertex_map.reshape(h * w, 3))
        ok = np.asarray(levels[0].vertex_valid.reshape(h * w))
        path = args.out.format(i)
        export_ply(path, pts[ok])
        print(f"frame {i}: {int(ok.sum())} points -> {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
