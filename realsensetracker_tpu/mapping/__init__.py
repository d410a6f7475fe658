"""Dense mapping: TSDF volume fusion + raycast model rendering.

The reference stops at a sparse voxel point map (CloudAccumulator,
rs_replay_app.cpp:76-129) and sketches frame-to-model tracking in a
compiled-out branch (:274-287). This package is the dense-map completion
of that plan, designed for an accelerator: the volume is a fixed-shape
(V, V, V) grid living in device memory, integration is one dense gather + elementwise update
over all voxels, and raycasting is a fixed-trip-count lax.fori_loop of
(H, W) gathers -- no trees, no sparse hashing, no dynamic shapes.
"""

from realsensetracker_tpu.mapping.mesh import (  # noqa: F401
    TriangleMesh,
    extract_mesh,
)
from realsensetracker_tpu.mapping.sharded import (  # noqa: F401
    init_volume_sharded,
    shard_volume,
    volume_sharding,
)
from realsensetracker_tpu.mapping.tsdf import (  # noqa: F401
    TsdfConfig,
    TsdfVolume,
    extract_surface,
    extract_surface_oriented,
    init_volume,
    integrate,
    raycast,
    raycast_coarse_to_fine,
    render_model_depth,
)
