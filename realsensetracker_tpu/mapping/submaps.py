"""Submap atlas: unbounded dense mapping from fixed-shape TSDF volumes.

A single TsdfVolume covers a fixed metric extent (TsdfConfig.resolution *
voxel_size); a trajectory that walks past it loses the model it tracks
against. The atlas keeps KinectFusion frame-to-model tracking inside the
NEWEST submap and, when the camera (or its view center) drifts past a
spawn radius, freezes the active volume and seeds a fresh one anchored at
the current world pose. The world model becomes a union of rigidly-placed
fixed-shape volumes -- the dense analog of the reference's unbounded
CloudAccumulator world map (rs_replay_app.cpp:76-129), in the
Kintinuous/submap-SLAM lineage.

Fixed shapes: every submap shares ONE TsdfConfig, so the whole lifetime of
the atlas reuses exactly the compiled programs of a single TsdfTracker
(raycast -> register -> integrate per frame, plus one seed dispatch per
spawn). No dynamic shapes anywhere; the host only does the spawn policy
arithmetic on the (19,) stats row it already receives per frame.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from realsensetracker_tpu.align import projective
from realsensetracker_tpu.geometry import camera
from realsensetracker_tpu.mapping import tsdf as tsdf_mod
from realsensetracker_tpu.ops import cloud as cloud_mod
from realsensetracker_tpu.tracking.trajectory import Trajectory


@dataclass(frozen=True)
class SubmapConfig:
    """Atlas policy knobs (the volume geometry lives in ``volume``)."""

    volume: tsdf_mod.TsdfConfig = tsdf_mod.TsdfConfig()
    spawn_radius: float = 0.0  # meters of camera/view-center drift from
    # the submap seed before a handover; 0 = auto (extent / 4)
    probe_depth: float = 0.0  # view-center probe distance along the
    # optical axis (captures rotation-induced frustum exit); 0 = auto
    # (extent / 4)
    min_frames: int = 4  # frames a submap must absorb before the next
    # spawn (guards against thrashing on a fast pan)
    offload_finished: bool = True  # move frozen volumes to host RAM
    # (device memory holds only the active one); extraction re-uploads
    # on demand
    reactivate: bool = True  # on drift, first try to RE-ENTER an existing
    # submap covering the current pose (registration-gated against its
    # render) before spawning a new one: bounds memory under revisits /
    # loitering and SNAPS accumulated drift onto the old map (implicit
    # loop closure)
    reactivate_min_inliers: float = 0.4  # inlier-fraction gate on the
    # reactivation registration (stricter than tracking: a wrong re-entry
    # would fuse the live stream into the wrong map)
    auto_slab: bool = True  # when volume.integrate_slab is unset (0),
    # default it to 3V/4 for submap volumes: submaps observe BOUNDED
    # local scenes (the spawn radius hands over before the view leaves
    # the volume), exactly the regime where frustum-restricted
    # integration engages, with the same fused volume (tests/
    # test_tsdf_integrate_slab.py; on the GPU, tests/test_gpu.py). Its
    # speed on the GPU is not measured. Safe by construction: frames whose AABB does
    # not fit fall back to the identical full pass inside the same
    # program.

    def radius(self) -> float:
        extent = self.volume.resolution * self.volume.voxel_size
        return self.spawn_radius or extent / 4.0

    def probe(self) -> float:
        extent = self.volume.resolution * self.volume.voxel_size
        return self.probe_depth or extent / 4.0


class Submap(NamedTuple):
    """An atlas entry. The ACTIVE submap's entry is a stale placeholder
    (its live volume/anchor sit in the inner tracker) refreshed whenever
    the tracker hands over to another submap."""

    world_from_submap: np.ndarray  # (4, 4) float32, host
    volume: object  # TsdfVolume (host leaves when offloaded)
    frames: int  # frames fused into it (accumulates across activations)


def pose_drifted(local_pose: np.ndarray, radius: float,
                 probe: float) -> bool:
    """Drift predicate shared by the atlas and the serving slots: camera
    position or mid-range view center moved > radius from where the
    submap was seeded (identity / (0, 0, probe))."""
    t = local_pose[:3, 3]
    if float(np.linalg.norm(t)) > radius:
        return True
    view = local_pose[:3, :3] @ np.array([0.0, 0.0, probe], np.float32) + t
    return float(np.linalg.norm(view - np.array([0.0, 0.0, probe]))) > radius


def _to_host(vol):
    return jax.tree.map(np.asarray, vol)


def _to_device(vol):
    return jax.tree.map(jnp.asarray, vol)


class SubmapTsdfTracker:
    """TsdfTracker facade over a growing atlas of fixed-shape submaps.

    Same streaming surface as tracking.tsdf_tracker.TsdfTracker
    (process / process_window / pose / trajectory / world_map /
    world_mesh / ...), but poses are WORLD poses (anchor-composed) and
    the world model is the union of all submaps.
    """

    def __init__(
        self,
        intr: camera.Intrinsics,
        config: SubmapConfig = SubmapConfig(),
        icp: projective.ProjectiveIcpConfig = projective.ProjectiveIcpConfig(),
        min_inlier_fraction: float = 0.2,
        surface_capacity: int = 65536,
        use_color: bool = False,
        photometric: object = None,  # RgbdIcpConfig | None
        photometric_ref: str = "frame",
        track_scale_fallback: float = 0.0,
    ):
        from realsensetracker_tpu.tracking.tsdf_tracker import TsdfTracker

        self.intr = intr
        if (config.auto_slab
                and int(getattr(config.volume, "integrate_slab", 0)) == 0):
            config = replace(config, volume=config.volume._replace(
                integrate_slab=3 * config.volume.resolution // 4))
        self.config = config
        self.surface_capacity = surface_capacity
        self.use_color = use_color
        # Inner tracker runs in the ACTIVE submap frame; its own
        # trajectory is ignored (ours is the world one).
        self._t = TsdfTracker(
            intr, volume=config.volume, icp=icp,
            min_inlier_fraction=min_inlier_fraction,
            surface_capacity=surface_capacity, use_color=use_color,
            photometric=photometric, photometric_ref=photometric_ref,
            track_scale_fallback=track_scale_fallback,
        )
        self._anchor = np.eye(4, dtype=np.float32)  # world_from_submap
        self._frames_in_active = 0
        self._active_id = -1  # -1 before the seed frame
        self._subs: list[Submap] = []  # one entry per submap id
        # (traj_start, submap_id) handover log: trajectory index `start`
        # onward was tracked in `submap_id` (until the next log entry).
        # optimize_atlas rewrites each span rigidly with its submap.
        self._span_log: list[tuple[int, int]] = []
        self.trajectory = Trajectory()
        self._pose_np = None  # last world pose (host)

    # -- policy ---------------------------------------------------------

    def _drifted(self, local_pose: np.ndarray) -> bool:
        return pose_drifted(local_pose, self.config.radius(),
                            self.config.probe())

    def _freeze_active(self) -> None:
        vol = self._t.tsdf_volume
        old = self._subs[self._active_id]
        self._subs[self._active_id] = Submap(
            world_from_submap=self._anchor,
            volume=_to_host(vol) if self.config.offload_finished else vol,
            frames=old.frames + self._frames_in_active,
        )

    def _try_reactivate(self, depth, color, world_pose: np.ndarray):
        """Re-enter an existing submap covering the current pose: verify
        by registering the live frame against that submap's render at the
        (drift-carrying) predicted local pose; on success the correction
        SNAPS the world pose onto the old map. Returns the corrected
        world pose, or None."""
        best = None
        for k, s in enumerate(self._subs):
            if k == self._active_id:
                continue
            local = np.linalg.inv(
                s.world_from_submap.astype(np.float64)
            ) @ world_pose
            if self._drifted(local.astype(np.float32)):
                continue
            d = float(np.linalg.norm(local[:3, 3]))
            if best is None or d < best[0]:
                best = (d, k, local.astype(np.float32))
        if best is None:
            return None
        _, k, local = best
        from realsensetracker_tpu.geometry import se3

        vol_k = _to_device(self._subs[k].volume)
        render = tsdf_mod.render_model_depth(
            vol_k, jnp.asarray(local), self.intr, self.config.volume
        )
        res = projective.register_depth_pair(
            jnp.asarray(depth, jnp.float32), render, self.intr, self._t.icp
        )
        # A re-entered submap only covers part of the current frustum
        # (the camera sits near its edge), so the absolute inlier
        # fraction conflates COVERAGE with misalignment: measured 0.33
        # on a correctly-aligned re-entry whose render filled 41% of the
        # frame. Gate the inlier fraction against the render coverage
        # (its attainable ceiling) plus a floor on coverage itself.
        cov = float((np.asarray(render) > 0).mean())
        inl = float(res.inlier_fraction)
        T = np.asarray(res.transform)
        ok = (np.isfinite(T).all() and cov >= 0.2
              and inl >= self.config.reactivate_min_inliers * cov)
        if not ok:
            return None
        local2 = np.asarray(se3.orthonormalize(
            se3.compose(jnp.asarray(local), res.transform)
        ), np.float32)
        self._freeze_active()
        self._active_id = k
        self._anchor = self._subs[k].world_from_submap
        # Fuse the live frame into the reactivated volume at the snapped
        # pose; the inner tracker continues from there.
        self._t._vol = tsdf_mod.integrate(
            vol_k, jnp.asarray(depth, jnp.float32), jnp.asarray(local2),
            self.intr, self.config.volume,
            color=self._t._color_frame(color),
        )
        self._t._pose = jnp.asarray(local2)
        self._t._pose_np = local2
        # Re-entry is a fresh episode for the inner tracker's cadence
        # state: the re-entry frame fused (slot 0), and reduced-res
        # tracking re-arms (the fallback latch is per-map).
        self._t._fuse_counter = 1
        self._t._track_cfg = self._t.volume
        self._t._low_cov_streak = 0
        if self._t.photometric is not None:
            # The re-entry frame becomes the next photometric reference.
            self._t._prev_gray = self._t._luma(
                self._t._color_frame(color)
            )
        self._frames_in_active = 1
        # This frame's pose was re-measured against submap k: its span
        # entry starts AT this frame (the already-appended trajectory
        # entry is rewritten by the caller with the snapped pose).
        self._span_log.append((len(self.trajectory) - 1, k))
        return (self._anchor @ local2).astype(np.float32)

    def _spawn_new(self, depth, color, world_pose: np.ndarray) -> None:
        vol = self._t.tsdf_volume
        # The frozen model raycast at the handover pose IS a depth frame
        # in the new submap's camera frame: fusing it hands the old
        # submap's accumulated (denoised) surface to the new one.
        handover = tsdf_mod.render_model_depth(
            vol, jnp.asarray(self._t.pose), self.intr, self.config.volume
        )
        self._freeze_active()
        self._subs.append(Submap(
            world_from_submap=np.asarray(world_pose, np.float32).copy(),
            volume=None,  # live in the inner tracker until frozen
            frames=0,
        ))
        self._active_id = len(self._subs) - 1
        # The handover frame was TRACKED in (and appended under) the old
        # submap; the new span starts at the next trajectory entry.
        self._span_log.append((len(self.trajectory), self._active_id))
        self._anchor = np.asarray(world_pose, np.float32).copy()
        # Handover frame fuses into BOTH volumes: process() already
        # integrated it into the frozen one; reseed fuses it (at
        # identity, together with the model render) as the new submap's
        # first surface, so the next frame tracks against a real render
        # -- no open-loop coast.
        self._t.reseed(depth, color=color, model_depth=handover)
        self._frames_in_active = 1

    def _maybe_handover(self, depth, color, world_pose: np.ndarray):
        """Handover policy after a successful frame: returns the snapped
        world pose if a reactivation happened, else None (whether or not
        a new submap spawned)."""
        if self._frames_in_active < self.config.min_frames:
            return None
        if not self._drifted(np.asarray(self._t.pose)):
            return None
        if self.config.reactivate:
            corrected = self._try_reactivate(depth, color, world_pose)
            if corrected is not None:
                return corrected
        self._spawn_new(depth, color, world_pose)
        return None

    # -- streaming ------------------------------------------------------

    def _seed_bookkeeping(self) -> None:
        if self._active_id < 0:
            self._subs.append(Submap(
                world_from_submap=self._anchor, volume=None, frames=0,
            ))
            self._active_id = 0
            self._span_log.append((len(self.trajectory), 0))

    def process(self, depth, timestamp: float | None = None, color=None):
        first = self._t.tsdf_volume is None
        r = self._t.process(depth, timestamp, color=color)
        if first:
            self._seed_bookkeeping()
        world_pose = (self._anchor @ r.pose).astype(np.float32)
        self._pose_np = world_pose
        self._frames_in_active += 1
        ts = timestamp if timestamp is not None else float(r.frame_index)
        self.trajectory.append(ts, world_pose)
        if r.success:
            corrected = self._maybe_handover(depth, color, world_pose)
            if corrected is not None:  # reactivation snapped this frame
                world_pose = corrected
                self._pose_np = corrected
                self.trajectory.poses[-1] = np.asarray(corrected,
                                                       np.float64)
        return r._replace(pose=world_pose)

    def process_window(self, depths, timestamps=None, window: int = 8,
                       colors=None):
        """Windowed variant: frames scan in up-to-``window`` chunks
        (TsdfTracker.process_window); the spawn check runs BETWEEN
        chunks, so a handover can land up to window-1 frames late --
        size spawn_radius with that slack (the default extent/4 leaves
        ~2x margin inside the volume)."""
        n = len(depths)
        if timestamps is None:
            timestamps = [None] * n
        results = []
        i = 0
        while i < n:
            first = self._t.tsdf_volume is None
            chunk = depths[i:i + window]
            cts = timestamps[i:i + window]
            cols = colors[i:i + window] if colors is not None else None
            rs = self._t.process_window(chunk, cts, window=window,
                                        colors=cols)
            if first:
                self._seed_bookkeeping()
            for j, r in enumerate(rs):
                world_pose = (self._anchor @ r.pose).astype(np.float32)
                self._pose_np = world_pose
                self._frames_in_active += 1
                ts = cts[j] if cts[j] is not None else float(r.frame_index)
                self.trajectory.append(ts, world_pose)
                results.append(r._replace(pose=world_pose))
            if results and results[-1].success:
                corrected = self._maybe_handover(
                    chunk[-1],
                    cols[-1] if cols is not None else None,
                    results[-1].pose,
                )
                if corrected is not None:
                    self._pose_np = corrected
                    self.trajectory.poses[-1] = np.asarray(corrected,
                                                           np.float64)
                    results[-1] = results[-1]._replace(pose=corrected)
            i += len(rs)
        return results

    # -- state ----------------------------------------------------------

    @property
    def pose(self):
        return self._pose_np

    @property
    def tsdf_volume(self):
        """The ACTIVE submap's device volume (None before the seed)."""
        return self._t.tsdf_volume

    @property
    def anchor(self) -> np.ndarray:
        """world_from_submap of the active submap."""
        return self._anchor

    @property
    def num_submaps(self) -> int:
        return len(self._subs)

    @property
    def active_id(self) -> int:
        """Index of the submap currently tracked in (-1 before seed)."""
        return self._active_id

    @property
    def submaps(self) -> list:
        """All atlas entries in id order, with the active one's LIVE
        anchor/volume substituted for its stale placeholder."""
        out = []
        for i, s in enumerate(self._subs):
            if i == self._active_id:
                out.append(s._replace(
                    world_from_submap=self._anchor,
                    volume=self._t.tsdf_volume,
                    frames=s.frames + self._frames_in_active,
                ))
            else:
                out.append(s)
        return out

    @property
    def finished(self) -> list:
        """Frozen (non-active) atlas entries, id order."""
        return [s for i, s in enumerate(self._subs)
                if i != self._active_id]

    def _all_volumes(self):
        """(world_from_submap, device TsdfVolume) for every submap in id
        order (the active one contributes its live volume)."""
        out = []
        for i, s in enumerate(self._subs):
            if i == self._active_id:
                out.append((self._anchor, self._t.tsdf_volume))
            else:
                out.append((s.world_from_submap, _to_device(s.volume)))
        return out

    # -- world-model extraction ------------------------------------------

    @property
    def world_map(self):
        """Union of all submap zero-level surfaces as ONE masked Cloud
        (surface_capacity points per submap, world frame)."""
        vols = self._all_volumes()
        if not vols:
            return None
        pts, masks = [], []
        for anchor, vol in vols:
            c = tsdf_mod.extract_surface(vol, self.config.volume,
                                         self.surface_capacity)
            a = jnp.asarray(anchor)
            pts.append(c.points @ a[:3, :3].T + a[:3, 3])
            masks.append(c.mask)
        return cloud_mod.Cloud(points=jnp.concatenate(pts),
                               mask=jnp.concatenate(masks))

    @property
    def world_map_oriented(self):
        """(Cloud, normals): union surface with TSDF-gradient normals
        rotated into the world frame."""
        vols = self._all_volumes()
        if not vols:
            return None
        pts, masks, nrms = [], [], []
        for anchor, vol in vols:
            c, nrm = tsdf_mod.extract_surface_oriented(
                vol, self.config.volume, self.surface_capacity
            )
            a = jnp.asarray(anchor)
            pts.append(c.points @ a[:3, :3].T + a[:3, 3])
            nrms.append(nrm @ a[:3, :3].T)
            masks.append(c.mask)
        return (cloud_mod.Cloud(points=jnp.concatenate(pts),
                                mask=jnp.concatenate(masks)),
                jnp.concatenate(nrms))

    @property
    def world_map_colored(self):
        """(Cloud, colors) union; None unless use_color."""
        if not self.use_color:
            return None
        vols = self._all_volumes()
        if not vols:
            return None
        pts, masks, cols = [], [], []
        for anchor, vol in vols:
            c, col = tsdf_mod.extract_surface_colored(
                vol, self.config.volume, self.surface_capacity
            )
            a = jnp.asarray(anchor)
            pts.append(c.points @ a[:3, :3].T + a[:3, 3])
            cols.append(col)
            masks.append(c.mask)
        return (cloud_mod.Cloud(points=jnp.concatenate(pts),
                                mask=jnp.concatenate(masks)),
                jnp.concatenate(cols))

    def world_mesh(self, capacity: int = 131072):
        """Union triangle mesh: each submap contributes up to
        capacity/num_submaps triangles (floor 4096), vertices transformed
        into the world frame. Triangle soups concatenate exactly
        (vis.render.export_mesh_ply welds at export)."""
        from realsensetracker_tpu.mapping.mesh import TriangleMesh, extract_mesh

        vols = self._all_volumes()
        if not vols:
            return None
        per = max(4096, capacity // len(vols))
        verts, masks, cols = [], [], []
        for anchor, vol in vols:
            m = extract_mesh(vol, self.config.volume, per,
                             with_color=self.use_color)
            a = jnp.asarray(anchor)
            verts.append(m.vertices @ a[:3, :3].T + a[:3, 3])
            masks.append(m.mask)
            if m.colors is not None:
                cols.append(m.colors)
        return TriangleMesh(
            vertices=jnp.concatenate(verts),
            mask=jnp.concatenate(masks),
            colors=jnp.concatenate(cols) if cols else None,
        )


# -- atlas-level loop closure + pose-graph optimization ----------------------


def _verify_submap_pairs(surfs, feats, pairs, *, noise_bound,
                         overlap_tau, min_overlap, refine_iters,
                         mesh=None, mesh_axis: str = "data"):
    """Geometric verification of candidate submap pairs in ONE dispatch.

    Same recipe as the keyframe loop-closure verifier
    (loop_closure/detector.py _verify_candidates): robust global
    registration (FPFH mutual matching -> max-k-core -> GNC-TLS),
    symmetric-overlap acceptance, ICP refinement kept only when it does
    not lose overlap. Registers surface_j ONTO surface_i, so the
    accepted transform is i_from_j = T_i^-1 T_j -- exactly the
    pose-graph edge measurement.

    The pair axis pads to a power of two (inert (0, 0) self-pairs, rows
    dropped from the result) so repeated atlas optimizations reuse one
    compiled program per capacity doubling instead of one per pair
    count. With ``mesh`` the padded pair axis shards over the mesh's
    ``mesh_axis`` (stores replicated -- a few MB; each chip verifies
    pairs/N candidates with zero hot-loop collectives), the same
    data-parallel shape as the serving slot axis.
    """
    n_pairs = len(pairs)
    cap = max(4, 1 << (n_pairs - 1).bit_length())
    if mesh is not None:
        n_dev = int(np.prod([mesh.shape[a] for a in mesh.axis_names]))
        cap = max(cap, n_dev)
        if cap % n_dev:
            cap = ((cap + n_dev - 1) // n_dev) * n_dev
    padded = list(pairs) + [(0, 0)] * (cap - n_pairs)

    pts = jnp.stack([s.points for s in surfs])
    msk = jnp.stack([s.mask for s in surfs])
    fts = jnp.stack(feats)
    pi = jnp.asarray([p[0] for p in padded], jnp.int32)
    pj = jnp.asarray([p[1] for p in padded], jnp.int32)
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P

        shard = NamedSharding(mesh, P(mesh_axis))
        repl = NamedSharding(mesh, P())
        pi = jax.device_put(pi, shard)
        pj = jax.device_put(pj, shard)
        pts, msk, fts = (jax.device_put(x, repl) for x in (pts, msk, fts))

    T, ok, ov = _verify_pairs_jit(
        pts, msk, fts, pi, pj, noise_bound=float(noise_bound),
        overlap_tau=float(overlap_tau), min_overlap=float(min_overlap),
        refine_iters=int(refine_iters),
    )
    return T[:n_pairs], ok[:n_pairs], ov[:n_pairs]


from functools import partial as _partial


@_partial(jax.jit, static_argnames=("noise_bound", "overlap_tau",
                                    "min_overlap", "refine_iters"))
def _verify_pairs_jit(pts, msk, fts, pi, pj, *, noise_bound, overlap_tau,
                      min_overlap, refine_iters):
    """Vmapped pair-verification program (one compiled program per
    (submap-count, pair-capacity, sharding) combination; the XLA SPMD
    partitioner splits the vmapped batch along the sharded pair axis
    when the operands carry a mesh sharding)."""
    from realsensetracker_tpu.align import icp as icp_mod
    from realsensetracker_tpu.align import robust_global

    def one(i, j):
        src = cloud_mod.Cloud(points=pts[j], mask=msk[j])  # submap j
        dst = cloud_mod.Cloud(points=pts[i], mask=msk[i])  # onto submap i
        res = robust_global.register_robust(
            src, dst, fts[j], fts[i], noise_bound
        )
        fwd, bwd = robust_global.symmetric_overlap(
            res.transform, src, dst, overlap_tau
        )
        ov = jnp.minimum(fwd, bwd)
        ok = res.valid & (ov >= min_overlap)
        ref = icp_mod.align_icp(
            src, dst, max_iter=refine_iters, init_transform=res.transform
        )
        f2, b2 = robust_global.symmetric_overlap(
            ref.transform, src, dst, overlap_tau
        )
        use_ref = jnp.all(jnp.isfinite(ref.transform)) & (
            jnp.minimum(f2, b2) >= ov
        )
        T = jnp.where(use_ref, ref.transform, res.transform)
        return T, ok, ov

    return jax.vmap(one)(pi, pj)


def _occupancy_signature(vol, cfg: tsdf_mod.TsdfConfig,
                         pool: int = 8) -> np.ndarray:
    """Coarse (G, G, G) near-surface occupancy mass of a volume, host
    NumPy: fraction of each pool^3 block whose voxels are observed AND
    within half the truncation band of the surface. Reads the HOST copy
    when the volume is offloaded -- no upload, no surface extraction.

    This is the cheap mid-gate signal for atlas loop closure: the
    pooled-FPFH place descriptor was measured NON-discriminative at
    submap scale (revisit cosine 0.986 vs 0.988 max over unrelated
    anchor-near pairs -- curvature statistics look alike everywhere on
    sphere/plane worlds), while warped-occupancy overlap separates
    cleanly (0.96 revisit / <= 0.08 unrelated)."""
    w = np.asarray(vol.weight) > 0
    t = np.abs(np.asarray(vol.tsdf)) < 0.5
    v = w.shape[0]
    g = max(v // pool, 1)
    trim = g * pool
    m = (w & t)[:trim, :trim, :trim]
    return m.reshape(g, pool, g, pool, g, pool).mean(axis=(1, 3, 5))


def _pair_overlap_score(ci: np.ndarray, cj: np.ndarray, T_ji: np.ndarray,
                        cfg: tsdf_mod.TsdfConfig, pool: int = 8) -> float:
    """Anchor-warped occupancy overlap of two submaps, in [0, 1]:
    sum(min(Ci, Cj o T_ji)) / min(mass_i, mass_j), where submap i's
    coarse cell centers warp into j's frame through the known relative
    anchor transform. A true revisit shares nearly all its observed mass
    (score ~1); anchor-near pairs that observed DIFFERENT geometry share
    almost none (~0.06-0.08 measured). Uses the CURRENT (drift-carrying)
    anchors, so it tolerates drift up to about one coarse cell
    (pool * voxel_size meters) -- the same assumption the anchor-distance
    gate already makes."""
    g = ci.shape[0]
    cell = cfg.voxel_size * pool
    o = np.asarray(cfg.origin, np.float64)
    idx = np.stack(
        np.meshgrid(*([np.arange(g)] * 3), indexing="ij"), -1
    ).reshape(-1, 3)
    centers = o + (idx + 0.5) * cell
    T = np.asarray(T_ji, np.float64)
    p = centers @ T[:3, :3].T + T[:3, 3]
    jidx = np.floor((p - o) / cell).astype(int)
    inside = np.all((jidx >= 0) & (jidx < g), axis=1)
    cj_at = np.zeros(len(idx))
    cj_at[inside] = cj[tuple(jidx[inside].T)]
    ci_f = ci.ravel()
    inter = float(np.minimum(ci_f, cj_at).sum())
    return inter / (min(float(ci_f.sum()), float(cj.sum())) + 1e-9)


def optimize_atlas(
    tracker: "SubmapTsdfTracker",
    *,
    surface_capacity: int = 2048,
    min_separation: int = 2,
    gate: float = 0.0,  # anchor-distance candidate gate; 0 = auto (extent)
    occupancy_gate: float = 0.25,  # warped-occupancy overlap mid-gate
    # between the (free) anchor gate and the (expensive) register+ICP
    # verification (see _pair_overlap_score): computed on HOST volume
    # copies BEFORE any upload/extraction, so at 20+ submaps both the
    # per-pair registration bill AND the per-submap surface+FPFH bill
    # shrink to the handful of genuinely-overlapping candidates.
    # 0 disables. Measured on a 20-submap corridor-with-revisit atlas:
    # 20 anchor-gated pairs -> 2 verified, identical accepted edges.
    occupancy_pool: int = 8,  # coarse-cell edge in voxels (drift
    # tolerance of the occupancy gate ~ pool * voxel_size meters)
    noise_bound: float = 0.0,  # 0 = auto (4 * voxel)
    overlap_tau: float = 0.0,  # 0 = auto (2 * voxel)
    min_overlap: float = 0.7,  # corridor floors/walls are translation-
    # invariant: sloppy x-shifted registrations still score ~0.5-0.6 on
    # the plane points (measured 127-320 mm edge error at ov 0.56-0.58,
    # vs 17-33 mm at ov >= 0.9), so the gate sits above the alias band
    loop_weight: float = 0.25,
    refine_iters: int = 16,
    feature_radius: float = 0.0,  # 0 = auto (6 * voxel)
    max_neighbors: int = 64,
    gn_iters: int = 10,
    cg_iters: int = 50,
    mesh=None,  # jax.sharding.Mesh: shard the pair verification over its
    # "data" axis (pure data parallelism -- see _verify_submap_pairs)
    mesh_axis: str = "data",
) -> int:
    """Loop-close and optimize the submap atlas IN PLACE; returns the
    number of accepted loop edges (0 = nothing changed).

    Non-adjacent submaps whose anchors sit within ``gate`` are verified
    against each other (FPFH from TSDF-gradient normals -- free, globally
    consistently oriented -- then the keyframe loop-closure recipe);
    accepted relative transforms become loop edges of a pose graph over
    the anchors (consecutive-anchor odometry edges form the backbone,
    optimize/pose_graph.py). Because every submap is rigid, applying the
    optimized anchors makes the WHOLE dense world model consistent
    instantly -- no re-integration of any volume -- and each submap's
    trajectory span is rewritten by its anchor correction.

    The keyframe SLAM stack (tracking/slam.py) corrects drift by
    re-fusing depths at optimized poses; this is the dense-first
    alternative: the map itself is the state being optimized.
    """
    from realsensetracker_tpu.ops import fpfh as fpfh_mod
    from realsensetracker_tpu.optimize import pose_graph as pg

    cfgv = tracker.config.volume
    voxel = cfgv.voxel_size
    extent = cfgv.resolution * voxel
    gate = gate or extent
    noise_bound = noise_bound or 4 * voxel
    overlap_tau = overlap_tau or 2 * voxel
    feature_radius = feature_radius or 6 * voxel

    # tracker.submaps substitutes the live anchor/volume for the active
    # entry but does NOT upload offloaded volumes -- the gates below run
    # on host copies, and only gate-surviving submaps pay the
    # upload + surface-extraction + FPFH bill.
    subs = tracker.submaps
    k = len(subs)
    if k < min_separation + 1:
        return 0

    anchors = np.stack(
        [s.world_from_submap for s in subs]
    ).astype(np.float32)
    pairs = []
    for i in range(k):
        for j in range(i + min_separation, k):
            if np.linalg.norm(anchors[i][:3, 3] - anchors[j][:3, 3]) < gate:
                pairs.append((i, j))
    if not pairs:
        return 0

    if occupancy_gate > 0:
        sigs = {}
        for idx in sorted({i for p in pairs for i in p}):
            sigs[idx] = _occupancy_signature(subs[idx].volume, cfgv,
                                             occupancy_pool)
        kept = []
        for i, j in pairs:
            T_ji = np.linalg.inv(
                anchors[j].astype(np.float64)
            ) @ anchors[i].astype(np.float64)
            score = _pair_overlap_score(sigs[i], sigs[j], T_ji, cfgv,
                                        occupancy_pool)
            if score >= occupancy_gate:
                kept.append((i, j))
        pairs = kept
        if not pairs:
            return 0

    # Upload + extract surfaces + FPFH only for submaps in surviving
    # pairs (at 20+ submaps most volumes never pay this).
    active = sorted({idx for p in pairs for idx in p})
    slot = {idx: s for s, idx in enumerate(active)}
    surfs, feats = [], []
    for idx in active:
        c, n = tsdf_mod.extract_surface_oriented(
            _to_device(subs[idx].volume), cfgv, surface_capacity
        )
        surfs.append(c)
        feats.append(fpfh_mod.compute_fpfh_from_normals(
            c, n, feature_radius, max_neighbors
        ))

    T, ok, _ov = _verify_submap_pairs(
        surfs, feats, [(slot[i], slot[j]) for i, j in pairs],
        noise_bound=noise_bound,
        overlap_tau=overlap_tau, min_overlap=min_overlap,
        refine_iters=refine_iters, mesh=mesh, mesh_axis=mesh_axis,
    )
    ok = np.asarray(ok)
    T = np.asarray(T)
    ov = np.asarray(_ov)
    # Confidence-weighted edges: measured edge error falls sharply with
    # overlap, so let the near-total-overlap loops dominate.
    loop_edges = [(i, j, T[c], loop_weight * float(ov[c]))
                  for c, (i, j) in enumerate(pairs) if ok[c]]
    if not loop_edges:
        return 0

    graph = pg.from_trajectory(jnp.asarray(anchors), loop_edges=loop_edges)
    new_anchors, _cost = pg.optimize_pose_graph(
        graph, gn_iters=gn_iters, cg_iters=cg_iters
    )
    new_anchors = np.asarray(new_anchors, np.float32)

    # Apply rigid per-submap corrections: anchors, then every trajectory
    # span tracked in that submap (the span log records handovers AND
    # reactivations, so revisited submaps carry all their spans).
    corrs = [
        new_anchors[idx] @ np.linalg.inv(anchors[idx].astype(np.float64))
        for idx in range(k)
    ]
    log = tracker._span_log
    for e, (start, sid) in enumerate(log):
        end = log[e + 1][0] if e + 1 < len(log) else len(tracker.trajectory)
        for t in range(start, end):
            tracker.trajectory.poses[t] = (
                corrs[sid] @ tracker.trajectory.poses[t]
            )
    for idx in range(k):
        if idx == tracker._active_id:
            tracker._anchor = new_anchors[idx]
        else:
            tracker._subs[idx] = tracker._subs[idx]._replace(
                world_from_submap=new_anchors[idx]
            )
    if tracker.trajectory.poses:
        tracker._pose_np = np.asarray(tracker.trajectory.poses[-1],
                                      np.float32)
    return len(loop_edges)
