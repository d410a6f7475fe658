"""rs-align: register one cloud/frame pair with the coarse-to-fine pipeline.

CLI port of rs_align_app (rs_align_app.cpp:243-389) with the same flag set
(:55-66): FPFH init, Lowe pruning, weighted Kabsch, ICP refinement, optional
robust global registration; renders FPFH-PCA colored clouds to PNG instead
of the live viewer.

Inputs: an .rsc clip + two frame indices, or two .npy (N, 3) cloud files.

Usage:
  python -m realsensetracker_tpu.cli.rs_align --clip clip.rsc --source-frame 20 \
      --target-frame 21 -v 0.05 -k 16 -r 0.5 --render out.png
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="rs-align", description=__doc__)
    p.add_argument("--source-file", "-s", default="",
                   help="Source cloud (.npy, or reference-recorded .pb)")
    p.add_argument("--target-file", "-t", default="",
                   help="Target cloud (.npy, or reference-recorded .pb)")
    p.add_argument("--clip", default="", help=".rsc clip to take frames from")
    p.add_argument("--source-frame", type=int, default=0)
    p.add_argument("--target-frame", type=int, default=1)
    # Flag set mirrors rs_align_app.cpp:55-66.
    p.add_argument("--voxel-size", "-v", type=float, default=0.05)
    p.add_argument("--normal-k", "-k", type=int, default=16)
    p.add_argument("--feature-radius", "-r", type=float, default=0.5)
    p.add_argument("--lowe-ratio", "-l", type=float, default=0.9)
    p.add_argument("--init-with-fpfh", "-i", type=int, default=1)
    p.add_argument("--refine-with-icp", "-x", type=int, default=1)
    p.add_argument("--use-robust", "-q", type=int, default=0,
                   help="GNC-TLS global registration (reference: use_teaser)")
    p.add_argument("--capacity", type=int, default=8192)
    p.add_argument("--render", default="", help="Output PNG path")
    return p


def _cloud_from_depth(depth, intr, capacity):
    import jax.numpy as jnp

    from realsensetracker_tpu.ops import cloud as cloud_mod
    from realsensetracker_tpu.ops.pyramid import build_pyramid

    # No normals: only vertex_map/vertex_valid are read below.
    levels, _ = build_pyramid(jnp.asarray(depth), intr, 1, with_normals=False)
    h, w = levels[0].vertex_valid.shape
    pts = np.asarray(levels[0].vertex_map.reshape(h * w, 3))
    ok = np.asarray(levels[0].vertex_valid.reshape(h * w))
    pts = pts[ok]
    if len(pts) > capacity:
        # Uniform stride over the raster-ordered valid pixels: a head
        # slice (pad_to_capacity drops the tail) would keep only the top
        # ~capacity/W image rows and register garbage slivers.
        idx = np.linspace(0, len(pts) - 1, capacity).astype(np.int64)
        pts = pts[idx]
    return cloud_mod.pad_to_capacity(pts, capacity)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from realsensetracker_tpu.utils.device import enable_compile_cache

    enable_compile_cache()
    import jax.numpy as jnp

    from realsensetracker_tpu.api.config import AlignConfig
    from realsensetracker_tpu.geometry import se3
    from realsensetracker_tpu.models.pairwise import align_pair
    from realsensetracker_tpu.ops import cloud as cloud_mod

    if args.clip:
        from realsensetracker_tpu.data import recorded

        clip = recorded.read_clip(args.clip)
        src = _cloud_from_depth(clip.depths[args.source_frame], clip.intrinsics, args.capacity)
        dst = _cloud_from_depth(clip.depths[args.target_frame], clip.intrinsics, args.capacity)
    elif args.source_file and args.target_file:
        def load_cloud(path):
            if path.endswith(".pb"):
                # Reference-recorded protobuf cloud (rs_viewer.cpp:105-112),
                # schema-free best-effort parse (data.pb_interop).
                from realsensetracker_tpu.data import pb_interop

                return pb_interop.read_pb_cloud(path)[0]
            return np.load(path)

        src = cloud_mod.pad_to_capacity(load_cloud(args.source_file), args.capacity)
        dst = cloud_mod.pad_to_capacity(load_cloud(args.target_file), args.capacity)
    else:
        print("need --clip or --source-file/--target-file", file=sys.stderr)
        return 1

    cfg = AlignConfig(
        voxel_size=args.voxel_size,
        normal_k=args.normal_k,
        feature_radius=args.feature_radius,
        lowe_ratio=args.lowe_ratio,
        init_with_fpfh=bool(args.init_with_fpfh),
        refine_with_icp=bool(args.refine_with_icp),
        use_robust=bool(args.use_robust),
        cloud_capacity=args.capacity,
    )
    res = align_pair(src, dst, cfg)
    T = np.asarray(res.transform)
    print("matches :", int(res.num_matches))
    print("icp mean cost :", float(res.icp_mean_cost))
    print("transform :\n", np.round(T, 6))

    if args.render:
        from realsensetracker_tpu.ops import fpfh as fpfh_mod
        from realsensetracker_tpu.vis import fpfh_pca_colors, render_cloud_png

        # Reuse align_pair's own downsample + features (recomputing the
        # O(N^2) FPFH pass here used to double the CLI latency).
        src_d = res.src_down
        if res.src_feats is not None:
            feats = np.asarray(res.src_feats)
        else:  # FPFH was skipped by the config: compute it for colors only
            feats = np.asarray(
                fpfh_mod.compute_fpfh(src_d, jnp.zeros(3), cfg.normal_k,
                                      cfg.feature_radius,
                                      cfg.fpfh_max_neighbors)
            )
        mask = np.asarray(src_d.mask)
        rec = np.asarray(se3.transform_points(res.transform, src_d.points))[mask]
        colors = fpfh_pca_colors(feats[mask])
        dst_np = np.asarray(dst.points)[np.asarray(dst.mask)]
        render_cloud_png(args.render, [(rec, colors), (dst_np, "green")])
        print(f"render -> {args.render}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
