"""realsensetracker_tpu: an RGB-D tracking framework in JAX.

A ground-up JAX/XLA rebuild of the capabilities of
yycho0108/RealsenseTracker (reference: /root/reference). The reference is a
CPU/C++17 point-cloud registration pipeline (KD-trees + Ceres); this framework
keeps the behavioral contract (frame in -> SE(3) pose out, same registration
semantics and tunables) but restructures the math around dense, fixed-shape,
mask-based tensor ops that XLA compiles for the GPU, with multi-device
scaling via jax.sharding.Mesh.

Layer map (mirrors reference rs_tracker/ modules -> JAX equivalents):
  geometry/   SE(3) exp/log + pinhole camera       (ref: Eigen Isometry3f use)
  ops/        point-cloud ops: unproject, normals, voxel, correspondence,
              FPFH, matching                        (ref: rs_tracker/common)
  align/      ICP / Kabsch / GICP / robust global  (ref: rs_tracker/align)
  data/       recorded-clip + TUM loaders, sources (ref: rs_tracker/driver)
  tracking/   frame-to-frame / keyframe VO, map accumulator, trajectory
  parallel/   mesh construction, batched/sharded registration
  models/     flagship pipeline presets (icp / gicp / fpfh+kabsch / robust)
  api/        public Tracker facade + config dataclasses
  cli/        command-line apps                     (ref: rs_tracker/app)
  vis/        offline visualization writers        (ref: rs_tracker/vis)
  utils/      profiling, logging, masking helpers
"""

__version__ = "0.1.0"

from realsensetracker_tpu.geometry import se3, camera  # noqa: F401
