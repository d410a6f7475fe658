"""Triangle-mesh extraction from a TSDF volume (marching tetrahedra).

Completes the dense-mapping output path: ``tsdf.extract_surface`` emits
the zero-level set as points (the analog of the reference's
ExtractPointCloud, rs_replay_app.cpp:113-122); this module emits it as a
watertight-where-observed TRIANGLE mesh for real downstream consumption
(rendering, collision, CAD).

Marching TETRAHEDRA rather than marching cubes, for two fixed-shape
reasons:

* **No transcribed case tables.** Each cube splits into the 6 Kuhn
  tetrahedra around the main diagonal; a tetrahedron has only 16 sign
  cases, each with at most 2 triangles, and the full (6, 16, 2, 3) table
  is DERIVED at import time from first principles -- crossing-edge
  enumeration plus a numerical winding check against the in-tet linear
  field's gradient (normals provably point from inside (tsdf < 0) into
  free space). Nothing hand-copied, nothing to mistranscribe.
* **Uniform dense work.** Every cell evaluates the same fixed expression
  graph: 8 shifted-view corner reads, per-edge lerps whose POSITIONS
  assemble from broadcast (V-1,) lines (the grid is affine in its
  indices, same trick as tsdf.integrate), one (16, 2, 3) table gather,
  and a fixed-capacity compaction. No per-cell control flow -- exactly
  the shape XLA tiles well.

The Kuhn decomposition is conforming across cells (every shared cube
face carries the same diagonal orientation), so edge vertices agree
between neighboring cells and the emitted soup welds into a connected
mesh (vis.render.export_mesh_ply does the host-side weld).

Cost model: the candidate set is 12 triangles per cell (6 tets x 2).
Each tet pass is one dense sweep over (V-1)^3 cells compacted straight
to ``capacity``, so peak memory is O((V-1)^3) transient + O(capacity)
retained -- an offline export path, not the tracking hot loop.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from realsensetracker_tpu.mapping import tsdf as tsdf_mod
from realsensetracker_tpu.ops import cloud as cloud_mod

# Cube corner c in 0..7 sits at offset (c & 1, c >> 1 & 1, c >> 2 & 1)
# voxel units from the cell's base voxel center.
_CORNER_BITS = np.array(
    [[c & 1, (c >> 1) & 1, (c >> 2) & 1] for c in range(8)], np.int32
)

# Kuhn subdivision: the 6 tetrahedra {0 <= x_s3 <= x_s2 <= x_s1 <= 1}
# over axis orderings, all sharing the 0-7 main diagonal. Conforming
# across translated copies (neighbors agree on face diagonals).
_TETS = (
    (0, 1, 3, 7), (0, 1, 5, 7), (0, 2, 3, 7),
    (0, 2, 6, 7), (0, 4, 5, 7), (0, 4, 6, 7),
)

# The 6 edges of a tetrahedron as (lo, hi) LOCAL vertex index pairs.
_TET_EDGES = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))
_EDGE_INDEX = {e: i for i, e in enumerate(_TET_EDGES)}


def _build_tri_tables() -> np.ndarray:
    """Derive the (6, 16, 2, 3) triangulation table.

    Entry [t, case, k] = the k-th triangle's 3 edge indices (into
    _TET_EDGES) for tet t under sign case ``case`` (bit i set = local
    vertex i inside, tsdf < 0); -1-padded. Winding is fixed numerically:
    each candidate triangle is evaluated on the representative config
    (inside = -1, outside = +1, edge midpoints) and flipped unless its
    normal aligns with the linear field's gradient (which points from
    inside to outside -- i.e. mesh normals face free space / the camera).
    """
    table = np.full((6, 16, 2, 3), -1, np.int32)
    for t, tet in enumerate(_TETS):
        pos = _CORNER_BITS[list(tet)].astype(np.float64)  # (4, 3)
        for case in range(16):
            neg = [i for i in range(4) if case >> i & 1]
            if len(neg) in (0, 4):
                continue
            vals = np.where(
                [(case >> i) & 1 for i in range(4)], -1.0, 1.0
            )
            # Linear field on the tet: f(x) = a.x + c (exact, 4 eqs).
            A = np.concatenate([pos, np.ones((4, 1))], axis=1)
            a = np.linalg.solve(A, vals)[:3]  # gradient, points outward

            def edge_pt(i, j):
                return 0.5 * (pos[i] + pos[j])  # midpoint at +-1 values

            def orient(tri_edges):
                p = [edge_pt(*_TET_EDGES[e]) for e in tri_edges]
                n = np.cross(p[1] - p[0], p[2] - p[0])
                if np.dot(n, a) < 0:
                    return (tri_edges[0], tri_edges[2], tri_edges[1])
                return tri_edges

            if len(neg) in (1, 3):
                k = neg[0] if len(neg) == 1 else next(
                    i for i in range(4) if i not in neg
                )
                others = [i for i in range(4) if i != k]
                tri = tuple(
                    _EDGE_INDEX[tuple(sorted((k, o)))] for o in others
                )
                table[t, case, 0] = orient(tri)
            else:  # 2 inside, 2 outside: a quad, split into 2 triangles
                na, nb = neg
                pc, pd = [i for i in range(4) if i not in neg]
                # Quad cycle ac -> ad -> bd -> bc (consecutive points
                # share a tet face, so the cycle is non-self-intersecting).
                e = [
                    _EDGE_INDEX[tuple(sorted((na, pc)))],
                    _EDGE_INDEX[tuple(sorted((na, pd)))],
                    _EDGE_INDEX[tuple(sorted((nb, pd)))],
                    _EDGE_INDEX[tuple(sorted((nb, pc)))],
                ]
                table[t, case, 0] = orient((e[0], e[1], e[2]))
                table[t, case, 1] = orient((e[0], e[2], e[3]))
    return table


_TRI_TABLES = _build_tri_tables()


class TriangleMesh(NamedTuple):
    """Fixed-capacity triangle soup: vertices (T, 3, 3), mask (T,) bool,
    optional per-vertex colors (T, 3, 3) in [0, 1]. Shared vertices
    between adjacent triangles repeat; vis.render.export_mesh_ply welds
    them at export."""

    vertices: jnp.ndarray
    mask: jnp.ndarray
    colors: jnp.ndarray | None = None

    @property
    def capacity(self) -> int:
        return self.vertices.shape[0]

    def count(self) -> jnp.ndarray:
        return jnp.sum(self.mask)


def _corner_view(grid: jnp.ndarray, c: int) -> jnp.ndarray:
    """(V-1,)^3 view of ``grid`` at cube-corner offset c."""
    v = grid.shape[0]
    bx, by, bz = _CORNER_BITS[c]
    return grid[bx:bx + v - 1, by:by + v - 1, bz:bz + v - 1]


def _tet_candidates(vol: tsdf_mod.TsdfVolume, cfg: tsdf_mod.TsdfConfig,
                    t: int, with_color: bool):
    """All candidate triangles of tet ``t`` across every cell: rows
    (2 * (V-1)^3, 9 [+9 color]) float32 + validity mask."""
    tet = _TETS[t]
    v = cfg.resolution
    c = v - 1
    n = c * c * c
    vs = jnp.float32(cfg.voxel_size)
    o = jnp.asarray(cfg.origin, jnp.float32)
    # Base voxel-center coordinate line per axis (affine in cell index).
    line = o[None, :] + (
        (jnp.arange(c, dtype=jnp.float32) + 0.5)[:, None] * vs
    )  # (c, 3); column a = world coordinate along axis a

    vals = [_corner_view(vol.tsdf, k) for k in tet]
    seen = _corner_view(vol.weight, tet[0]) > 0
    for k in tet[1:]:
        seen = seen & (_corner_view(vol.weight, k) > 0)
    case = sum(
        (vals[i] < 0).astype(jnp.int32) << i for i in range(4)
    ).reshape(n)

    cols = cws = None
    if with_color:
        cols = [_corner_view_color(vol.color, k) for k in tet]
        # Color fuses only in the near-surface band, so a geometric
        # crossing can straddle one voxel that never received color
        # (color_weight 0, rgb 0): lerping with it would darken the
        # vertex. Fall back to the colored endpoint instead.
        cws = [
            (_corner_view(vol.color_weight, k) > 0).reshape(n)
            for k in tet
        ]

    edge_pts, edge_cols = [], []
    for a, b in _TET_EDGES:
        va, vb = vals[a], vals[b]
        denom = va - vb
        frac = jnp.clip(
            va / jnp.where(jnp.abs(denom) > 1e-12, denom, 1e-12), 0.0, 1.0
        ).reshape(n)
        bits_a = _CORNER_BITS[tet[a]]
        delta = (_CORNER_BITS[tet[b]] - bits_a).astype(np.float32)
        axes = []
        for ax in range(3):
            base = (
                line[:, ax].reshape(
                    [c if d == ax else 1 for d in range(3)]
                )
                + jnp.float32(bits_a[ax]) * vs
            )
            p = jnp.broadcast_to(base, (c, c, c)).reshape(n)
            if delta[ax]:
                p = p + frac * (jnp.float32(delta[ax]) * vs)
            axes.append(p)
        edge_pts.append(jnp.stack(axes, axis=-1))  # (n, 3)
        if with_color:
            ca, cb = cols[a].reshape(n, 3), cols[b].reshape(n, 3)
            lerp = ca + frac[:, None] * (cb - ca)
            both = (cws[a] & cws[b])[:, None]
            one = jnp.where(cws[a][:, None], ca, cb)
            edge_cols.append(jnp.where(both, lerp, one))
    epts = jnp.stack(edge_pts, axis=1)  # (n, 6, 3)

    ids = jnp.asarray(_TRI_TABLES[t])[case]  # (n, 2, 3)
    flat = ids.clip(0).reshape(n, 6)
    tris = jnp.take_along_axis(epts, flat[:, :, None], axis=1)
    rows = tris.reshape(n * 2, 9)
    valid = ((ids[:, :, 0] >= 0) & seen.reshape(n)[:, None]).reshape(n * 2)
    if with_color:
        ecol = jnp.stack(edge_cols, axis=1)  # (n, 6, 3)
        crow = jnp.take_along_axis(
            ecol, flat[:, :, None], axis=1
        ).reshape(n * 2, 9)
        rows = jnp.concatenate([rows, crow], axis=-1)
    return rows, valid


def _corner_view_color(color: jnp.ndarray, c: int) -> jnp.ndarray:
    v = color.shape[0]
    bx, by, bz = _CORNER_BITS[c]
    return color[bx:bx + v - 1, by:by + v - 1, bz:bz + v - 1]


@partial(jax.jit, static_argnames=("cfg", "capacity", "with_color"))
def extract_mesh(
    vol: tsdf_mod.TsdfVolume,
    cfg: tsdf_mod.TsdfConfig = tsdf_mod.TsdfConfig(),
    capacity: int = 131072,
    with_color: bool = False,
) -> TriangleMesh:
    """Zero-level surface of ``vol`` as a fixed-capacity triangle mesh.

    Triangles appear only between voxel pairs BOTH observed (weight > 0),
    winding makes normals face free space (toward the cameras that carved
    it), and when the crossing count exceeds ``capacity`` the compaction
    keeps a spatially uniform subsample (ops.cloud.subsample_to_capacity
    semantics). ``with_color=True`` (colored volumes) interpolates the
    fused per-voxel RGB onto each vertex.
    """
    if with_color and vol.color is None:
        raise ValueError(
            "extract_mesh(with_color=True) needs a colored volume "
            "(init_volume(with_color=True))"
        )
    # One dense sweep per tet, each compacted straight to `capacity` so
    # peak retained memory is 6 * capacity rows, then a final merge.
    parts = [
        tsdf_mod._compact_to_capacity(
            *(_tet_candidates(vol, cfg, t, with_color)), capacity
        )
        for t in range(6)
    ]
    merged = tsdf_mod._compact_to_capacity(
        jnp.concatenate([p.points for p in parts], axis=0),
        jnp.concatenate([p.mask for p in parts], axis=0),
        capacity,
    )
    verts = merged.points[:, :9].reshape(capacity, 3, 3)
    colors = (
        merged.points[:, 9:].reshape(capacity, 3, 3) if with_color else None
    )
    return TriangleMesh(vertices=verts, mask=merged.mask, colors=colors)
