"""Cross-session dynamic batching for the tracking service.

The reference is one process tracking one stream (rs_replay_app.cpp:
159-415). A serving deployment is the opposite shape: MANY producers
POST frames to one device, and a single 640x480 frame is too little work
to fill it. Serializing sessions — the plain TrackingService behavior —
pays one dispatch and its fixed host cost per session per frame.

`BatchedExecutor` instead coalesces concurrently-pending `/track` requests
across sessions into ONE device dispatch: each session owns a slot of a
device-resident `parallel.streams.StreamState`, and a dispatcher thread
drains whatever requests are queued into a single
`step_streams_masked` call (inactive slots untouched, first frames seed
their slot at identity). Batching is continuous-batching style: while one
dispatch runs (~45+ ms), new requests pile up and form the next batch —
under load, S sessions cost ~1 dispatch per frame-interval instead of S.

Semantics per slot are frame-to-frame visual odometry with
failure-holds-pose (rs_replay_app.cpp:266-273), i.e. the batched serving
analog of `Tracker(method="projective")` without the world model; with
`BatchingConfig(rgbd=True)` the joint point-to-plane + photometric
objective (align/rgbd.py) replaces depth-only ICP and sessions POST
depth+color bodies.

Usage (see cli/rs_serve.py `--batched`):

    ex = BatchedExecutor(BatchingConfig(intrinsics=intr, capacity=8))
    svc = TrackingService(ex.make_session_tracker, extra_status=ex.stats)
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from realsensetracker_tpu.align import projective, rgbd as rgbd_mod
from realsensetracker_tpu.geometry import camera
from realsensetracker_tpu.parallel import streams
from realsensetracker_tpu.tracking.frame_to_frame import FrameResult
from realsensetracker_tpu.tracking.trajectory import Trajectory


@dataclass(frozen=True)
class BatchingConfig:
    """Executor configuration (shapes are fixed at construction: one
    compiled program serves every batch; a new shape would recompile)."""

    intrinsics: camera.Intrinsics
    icp: projective.ProjectiveIcpConfig = projective.ProjectiveIcpConfig()
    capacity: int = 8  # max concurrent sessions (slots)
    min_inlier_fraction: float = 0.2
    mesh: object = None  # jax.sharding.Mesh | None: shard the slot axis
    # over `data_axis` so serving capacity scales with chips (each device
    # runs capacity/n_data slots' ICP; registrations are independent, the
    # hot loop needs zero collectives -- SURVEY.md section 5.8). Capacity
    # must be a multiple of the mesh's data-axis size.
    data_axis: str = "data"
    linger_ms: float = 0.0  # wait this long after the first pending
    # request before dispatching, letting co-arriving requests coalesce.
    # 0 dispatches at once: requests that arrive during a dispatch form
    # the next batch. Raise it for deterministic batching in tests.
    request_timeout_s: float = 600.0  # bound on one request's wait (the
    # first dispatch pays the compile)
    window: int = 1  # max frames per request. >1 adds a SECOND compiled
    # program (a lax.scan of the masked step over the window axis,
    # streams.step_streams_masked_window) used for rounds where any
    # session posted a multi-frame batch (/track_window): the dispatch
    # amortizes across sessions AND along time. Rounds of single frames
    # keep using the cheaper per-step program.
    rgbd: bool = False  # joint depth+photometric odometry per slot
    # (align/rgbd.py): every frame must then carry an intensity/color
    # plane. Use for geometry-degenerate scenes (flat walls) where
    # depth-only projective ICP cannot observe in-plane motion.
    rgbd_icp: rgbd_mod.RgbdIcpConfig = rgbd_mod.RgbdIcpConfig()
    tsdf: bool = False  # dense frame-to-model slots: each session owns a
    # device-resident TSDF volume (KinectFusion loop per slot,
    # streams.step_tsdf_streams_masked). Device memory = capacity * 2 *
    # V^3 * 4 bytes -- size capacity accordingly. Mutually exclusive with
    # rgbd. The vmapped batch runs max-shaped programs and computes both
    # sides of each slot's integrate select; whether it beats one
    # serialized TsdfTracker per session on the GPU is not measured.
    tsdf_cfg: object = None  # mapping.tsdf.TsdfConfig | None (defaults)
    tsdf_submap_radius: float = 0.0  # tsdf slots: > 0 gives every session
    # UNBOUNDED extent via anchor-composed reseeds -- when the camera (or
    # its view center) drifts past this radius from the slot's last seed,
    # the next frame reseeds the volume at the current pose and the
    # session facade composes poses through the accumulated anchor
    # (mapping/submaps.py semantics minus the model-render handover: the
    # reseed restarts from the raw frame, one frame of open-loop coast
    # per handover). 0 = fixed single volume per session.
    depth_scale: float = 1e-3  # meters per raw unit for INTEGER depth
    # frames (RealSense Z16 default 1 mm; TUM PNGs 1/5000). Sessions may
    # post raw uint16 frames at HALF the f32 upload bytes: when every
    # request in a round is integer, the round stages uint16 and the
    # compiled step converts on device (ops/pyramid.depth_to_meters);
    # mixed rounds convert the integer frames on host. Float frames are
    # always taken as meters.


class SessionDesyncError(RuntimeError):
    """A request timed out AFTER its frame was handed to the dispatcher:
    the frame will still be applied to the slot's device state, so the
    session facade's view (frame index, trajectory) no longer matches the
    device. The session must be reset (its slot reseeds on reuse)."""


class _Request:
    __slots__ = ("depths", "grays", "seed", "event", "rows", "error")

    def __init__(self, depths: np.ndarray, grays: np.ndarray | None,
                 seed: bool):
        self.depths = depths  # (n, H, W), 1 <= n <= config.window
        self.grays = grays  # (n, H, W) [0, 1] | None (rgbd executors only)
        self.seed = seed  # first frame (row 0) (re)seeds the slot
        self.event = threading.Event()
        self.rows: np.ndarray | None = None  # (n, stats_width)
        self.error: BaseException | None = None


class SlotResult:
    """Unpacked masked-step stats row for one slot (35-wide depth-only or
    36-wide RGB-D; see streams.MASKED_STATS_WIDTH/MASKED_RGBD_STATS_WIDTH)."""

    __slots__ = ("pose", "relative", "success", "rmse", "photo_rmse",
                 "inlier_fraction")

    def __init__(self, row: np.ndarray):
        self.pose = row[0:16].reshape(4, 4).astype(np.float32)
        self.relative = row[16:32].reshape(4, 4).astype(np.float32)
        self.success = bool(row[32] > 0.5)
        self.rmse = float(row[33])
        if len(row) == streams.MASKED_RGBD_STATS_WIDTH:
            self.photo_rmse = float(row[34])
            self.inlier_fraction = float(row[35])
        else:
            self.photo_rmse = None
            self.inlier_fraction = float(row[34])


class BatchedExecutor:
    """Owns the device StreamState + the dispatcher thread.

    Thread model: handler threads enqueue into per-slot FIFO queues and
    block on an event; the single dispatcher thread drains at most one
    request per slot per round (preserving per-session frame order), runs
    one `step_streams_masked` dispatch, and delivers the packed rows.
    Device work is inherently serialized by the single dispatcher — the
    service must NOT additionally hold its own lock around `process` (see
    `supports_concurrent_process` on the session facade).
    """

    def __init__(self, config: BatchingConfig):
        if config.capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {config.capacity}")
        if config.window < 1:
            raise ValueError(f"window must be >= 1, got {config.window}")
        if config.rgbd and config.tsdf:
            raise ValueError("rgbd and tsdf slot modes are mutually "
                             "exclusive")
        if config.tsdf_submap_radius and not config.tsdf:
            raise ValueError("tsdf_submap_radius requires tsdf slot mode")
        if config.mesh is not None:
            n_data = config.mesh.shape[config.data_axis]
            if config.capacity % n_data != 0:
                raise ValueError(
                    f"capacity ({config.capacity}) must be a multiple of "
                    f"the mesh '{config.data_axis}' axis size ({n_data}) "
                    "so slots shard evenly over devices"
                )
        self.config = config
        self._cond = threading.Condition()
        self._pending: dict[int, deque[_Request]] = {}
        self._free = list(range(config.capacity - 1, -1, -1))
        self._prefer_singles = True  # mixed-round alternation (see _run)
        # Per-slot generation: bumped on every acquisition so a STALE
        # facade (its session was /reset while a request loop was still
        # running) cannot enqueue into a reacquired slot and corrupt the
        # new session's device state.
        self._gen = [0] * config.capacity
        self._stop = False
        self._state = None  # device StreamState, built on first dispatch
        # stats (guarded by _cond)
        self._dispatches = 0
        self._frames = 0  # individual frames (window requests count n)
        self._sessions_served = 0  # per-round session count, summed
        self._max_batch = 0  # max sessions in one round
        self._errors = 0  # failed dispatch rounds (delivered as 500s)
        self._thread = threading.Thread(
            target=self._run, name="rst-batch-dispatch", daemon=True
        )
        self._thread.start()

    # -- session lifecycle ----------------------------------------------

    def make_session_tracker(self) -> "BatchedSessionTracker":
        """TrackingService-compatible factory: one tracker facade = one
        slot. Raises RuntimeError when all slots are taken."""
        return BatchedSessionTracker(self, *self._acquire_slot())

    def _acquire_slot(self) -> tuple[int, int]:
        with self._cond:
            if self._stop:
                raise RuntimeError("executor is closed")
            if not self._free:
                raise RuntimeError(
                    f"batch capacity exhausted ({self.config.capacity} "
                    "concurrent sessions); reset an idle session or raise "
                    "BatchingConfig.capacity"
                )
            slot = self._free.pop()
            self._gen[slot] += 1
            self._pending[slot] = deque()
            return slot, self._gen[slot]

    def _release_slot(self, slot: int, gen: int | None = None) -> None:
        with self._cond:
            if gen is not None and self._gen[slot] != gen:
                return  # a stale facade must not free its successor's slot
            q = self._pending.pop(slot, None)
            if q is None:
                return  # already released
            for req in q:  # unblock anyone still waiting on this session
                req.error = RuntimeError("session was reset/released")
                req.event.set()
            self._free.append(slot)

    # -- request path -----------------------------------------------------

    def track(self, slot: int, depth: np.ndarray, seed: bool,
              gray: np.ndarray | None = None,
              gen: int | None = None) -> SlotResult:
        """Blocking: enqueue one frame for `slot`, wait for its batch."""
        return self.track_window(
            slot, np.asarray(depth)[None], seed,
            grays=None if gray is None
            else np.asarray(gray, np.float32)[None],
            gen=gen,
        )[0]

    def track_window(self, slot: int, depths: np.ndarray, seed: bool,
                     grays: np.ndarray | None = None,
                     gen: int | None = None) -> list[SlotResult]:
        """Blocking: enqueue up to `config.window` frames for `slot` as ONE
        request, wait for the round that carries them. Returns one
        SlotResult per frame, in order. `gen` (from _acquire_slot) guards
        against a stale facade writing into a reacquired slot."""
        intr = self.config.intrinsics
        shape = (int(intr.height), int(intr.width))
        # Integer frames stay RAW (uint16: half the f32 upload bytes;
        # meters = raw * config.depth_scale on device); floats are
        # meters. Integers that do NOT fit uint16 convert to meters here
        # instead of wrapping (data/depth_units.stage_depth_np).
        from realsensetracker_tpu.data.depth_units import stage_depth_np

        depths, _ = stage_depth_np(depths, self.config.depth_scale)
        if depths.ndim != 3 or depths.shape[1:] != shape:
            raise ValueError(
                f"frame batch shape {depths.shape} != (n,) + service shape "
                f"{shape} (one compiled program serves all sessions)"
            )
        if not 1 <= len(depths) <= self.config.window:
            raise ValueError(
                f"request carries {len(depths)} frames; the executor "
                f"window is {self.config.window} (BatchingConfig.window)"
            )
        if self.config.rgbd:
            if grays is None:
                raise ValueError(
                    "rgbd executor: every frame needs an intensity/color "
                    "plane (post .npz depth+color bodies)"
                )
            grays = np.asarray(grays, np.float32)
            if grays.shape != depths.shape:
                raise ValueError(
                    f"grays shape {grays.shape} != depths {depths.shape}"
                )
        else:
            grays = None  # interface parity: ignored, like Tracker color
        req = _Request(depths, grays, seed)
        with self._cond:
            if self._stop:
                raise RuntimeError("executor is closed")
            if gen is not None and self._gen[slot] != gen:
                raise RuntimeError(
                    "session was reset/released (its slot belongs to a "
                    "newer session now)"
                )
            q = self._pending.get(slot)
            if q is None:
                raise RuntimeError(f"slot {slot} is not active")
            q.append(req)
            self._cond.notify_all()
        if not req.event.wait(self.config.request_timeout_s):
            # Cancel if still queued: the frame never reached the device,
            # so the caller may safely retry it. If the dispatcher already
            # took it, the frame WILL mutate the slot's device state even
            # though we return failure here -- that session is
            # desynchronized and must be reset (SessionDesyncError).
            with self._cond:
                q = self._pending.get(slot)
                cancelled = False
                if q is not None:
                    try:
                        q.remove(req)
                        cancelled = True
                    except ValueError:
                        pass
            if cancelled:
                raise TimeoutError(
                    f"batched track timed out after "
                    f"{self.config.request_timeout_s}s (frame was never "
                    "dispatched; safe to retry)"
                )
            if not req.event.is_set():  # in flight right now
                raise SessionDesyncError(
                    f"batched track timed out after "
                    f"{self.config.request_timeout_s}s with the frame "
                    "in-flight on the device; the slot state will advance "
                    "without this session seeing the result -- reset the "
                    "session"
                )
            # completed between the wait timing out and the lock: fall
            # through and deliver the (valid) result.
        if req.error is not None:
            raise req.error
        return [SlotResult(row) for row in req.rows]

    # -- dispatcher -------------------------------------------------------

    def _run(self) -> None:
        while True:
            with self._cond:
                while not self._stop and not any(self._pending.values()):
                    self._cond.wait()
                if self._stop:
                    for q in self._pending.values():
                        for req in q:
                            req.error = RuntimeError("executor is closed")
                            req.event.set()
                    self._pending.clear()
                    return
                if self.config.linger_ms > 0:
                    deadline = (
                        time.monotonic() + self.config.linger_ms / 1000.0
                    )
                    while not self._stop:
                        # Early out once EVERY active session has a frame
                        # queued -- the batch cannot get any fuller, so the
                        # rest of the linger would be pure added latency.
                        if self._pending and all(self._pending.values()):
                            break
                        rem = deadline - time.monotonic()
                        if rem <= 0:
                            break
                        self._cond.wait(timeout=rem)
                    if self._stop:
                        continue  # top of loop delivers shutdown errors
                # One request per slot per round keeps per-session order.
                # Single-frame and multi-frame (window) requests never
                # share a round: a mixed round would run EVERY slot through
                # the full cfg.window scan program, coupling single-frame
                # sessions' latency to the window length. When both kinds
                # are pending, alternate so neither starves.
                heads = {
                    slot: q[0] for slot, q in self._pending.items() if q
                }
                singles = {s for s, r in heads.items()
                           if len(r.depths) == 1}
                multis = {s for s, r in heads.items() if len(r.depths) > 1}
                if singles and multis:
                    pick = singles if self._prefer_singles else multis
                    self._prefer_singles = not self._prefer_singles
                else:
                    pick = singles or multis
                batch = {
                    slot: self._pending[slot].popleft() for slot in pick
                }
            if batch:
                self._dispatch(batch)

    def _dispatch(self, batch: dict[int, _Request]) -> None:
        cfg = self.config
        s = cfg.capacity
        h, w = int(cfg.intrinsics.height), int(cfg.intrinsics.width)
        n_frames = sum(len(req.depths) for req in batch.values())
        try:
            windowed = any(len(req.depths) > 1 for req in batch.values())
            if self._state is None:
                if cfg.rgbd:
                    self._state = streams.blank_streams_rgbd(
                        cfg.intrinsics, cfg.rgbd_icp, num_streams=s
                    )
                elif cfg.tsdf:
                    self._state = streams.blank_tsdf_streams(
                        cfg.intrinsics, cfg.tsdf_cfg, num_streams=s
                    )
                else:
                    self._state = streams.blank_streams(
                        cfg.intrinsics, cfg.icp, num_streams=s
                    )
                if cfg.mesh is not None:
                    self._state = streams.shard_streams(
                        self._state, cfg.mesh, cfg.data_axis
                    )
            # A round where EVERY request posted raw integer frames
            # stages uint16 (half the upload; the compiled step converts
            # on device). Mixed rounds fall back to f32, converting the
            # integer requests on host. Each dtype is its own compiled
            # program (compiled once).
            all_int = all(
                np.issubdtype(req.depths.dtype, np.integer)
                for req in batch.values()
            )
            ddtype = np.uint16 if all_int else np.float32
            depth_scale = cfg.depth_scale if all_int else 1.0

            def as_staged(d):
                if all_int or not np.issubdtype(d.dtype, np.integer):
                    return d
                from realsensetracker_tpu.data.depth_units import (
                    to_meters_np,
                )

                return to_meters_np(d, cfg.depth_scale)

            if windowed:
                wlen = cfg.window
                depths = np.zeros((s, wlen, h, w), ddtype)
                grays = np.zeros((s, wlen, h, w), np.float32)
                active = np.zeros((s, wlen), bool)
                seed = np.zeros((s, wlen), bool)
                for slot, req in batch.items():
                    n = len(req.depths)
                    depths[slot, :n] = as_staged(req.depths)
                    if req.grays is not None:
                        grays[slot, :n] = req.grays
                    active[slot, :n] = True
                    seed[slot, 0] = req.seed
                step = (streams.step_streams_masked_rgbd_window if cfg.rgbd
                        else streams.step_tsdf_streams_masked_window
                        if cfg.tsdf
                        else streams.step_streams_masked_window)
            else:
                depths = np.zeros((s, h, w), ddtype)
                grays = np.zeros((s, h, w), np.float32)
                active = np.zeros((s,), bool)
                seed = np.zeros((s,), bool)
                for slot, req in batch.items():
                    depths[slot] = as_staged(req.depths[0])
                    if req.grays is not None:
                        grays[slot] = req.grays[0]
                    active[slot] = True
                    seed[slot] = req.seed
                step = (streams.step_streams_masked_rgbd if cfg.rgbd
                        else streams.step_tsdf_streams_masked if cfg.tsdf
                        else streams.step_streams_masked)
            raw = ((depths, grays, active, seed) if cfg.rgbd
                   else (depths, active, seed))
            if cfg.mesh is not None:
                # Committed slot-sharded inputs make the jitted step run
                # sharded over the mesh (state is already sharded). One
                # host->device transfer per input: device_put straight
                # from numpy to the sharded layout.
                from jax.sharding import NamedSharding, PartitionSpec as P

                inputs = tuple(
                    jax.device_put(x, NamedSharding(
                        cfg.mesh,
                        P(cfg.data_axis, *([None] * (x.ndim - 1))),
                    ))
                    for x in raw
                )
            else:
                inputs = tuple(jnp.asarray(x) for x in raw)
            tail = ((cfg.rgbd_icp,) if cfg.rgbd
                    else (cfg.tsdf_cfg, cfg.icp) if cfg.tsdf
                    else (cfg.icp,))
            self._state, stats = step(
                self._state,
                *inputs,
                cfg.intrinsics,
                *tail,
                min_inlier_fraction=cfg.min_inlier_fraction,
                depth_scale=depth_scale,
            )
            rows = np.asarray(stats)  # the batch's ONE host transfer
        except BaseException as e:  # deliver, don't kill the dispatcher
            with self._cond:
                self._errors += 1
            for req in batch.values():
                req.error = e
                req.event.set()
            return
        with self._cond:
            self._dispatches += 1
            self._frames += n_frames
            self._sessions_served += len(batch)
            self._max_batch = max(self._max_batch, len(batch))
        for slot, req in batch.items():
            req.rows = (rows[slot, : len(req.depths)] if windowed
                        else rows[slot][None])
            req.event.set()

    # -- observability / shutdown ----------------------------------------

    def stats(self) -> dict:
        with self._cond:
            d, f = self._dispatches, self._frames
            return {
                "capacity": self.config.capacity,
                "active_sessions": len(self._pending),
                "dispatches": d,
                "frames": f,  # individual frames (window requests count n)
                # sessions coalesced per round -- NOT frames/dispatches,
                # which would conflate the window and cross-session levers
                "mean_batch": (round(self._sessions_served / d, 3)
                               if d else 0.0),
                "max_batch": self._max_batch,
                "errors": self._errors,
            }

    def close(self) -> None:
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        self._thread.join(timeout=10.0)


class BatchedSessionTracker:
    """One session's tracker facade over a shared BatchedExecutor slot.

    API-compatible with the trackers TrackingService wraps (`process` ->
    FrameResult, `.pose`, `.trajectory`); `supports_concurrent_process`
    tells the service NOT to hold its device lock across `process` — the
    whole point is that concurrent sessions' calls coalesce into one
    dispatch inside the executor.
    """

    supports_concurrent_process = True
    # Raw integer (u16) frames pass through to the executor, which stages
    # them at half the f32 bytes and converts on device
    # (BatchingConfig.depth_scale).
    accepts_raw_depth = True

    @property
    def depth_scale(self) -> float:
        """The executor's meters-per-raw-unit -- lets the service verify
        its own depth_scale agrees before passing raw frames through."""
        return self._ex.config.depth_scale

    def __init__(self, executor: BatchedExecutor, slot: int, gen: int):
        self._ex = executor
        self._slot = slot
        self._gen = gen  # slot generation (stale-facade guard)
        self._lock = threading.Lock()  # per-session frame order
        self._index = 0
        self._desynced = False  # a timed-out frame mutated the slot anyway
        self._pose_np = np.eye(4, dtype=np.float32)
        self.trajectory = Trajectory()
        # Submap-style unbounded extent (tsdf_submap_radius > 0): slot
        # poses are LOCAL to the last reseed; the facade composes them
        # through the accumulated anchor and schedules a reseed when the
        # local pose drifts past the radius.
        self._anchor = np.eye(4, dtype=np.float32)
        self._pending_seed = False
        self._frames_since_seed = 0
        self.num_reseeds = 0

    @property
    def window_capacity(self) -> int:
        """Frames one executor request can scan (BatchingConfig.window)."""
        return self._ex.config.window

    @property
    def pose(self) -> np.ndarray:
        return self._pose_np

    def process(self, depth, timestamp: float | None = None,
                color=None) -> FrameResult:
        """One frame in -> FrameResult out. Depth-only executors accept and
        ignore `color` (interface parity with method='projective'); rgbd
        executors require it (gray or RGB, converted like api.Tracker)."""
        gray = self._gray(color)
        with self._lock:
            self._check_sync()
            ts = float(self._index) if timestamp is None else timestamp
            try:
                r = self._ex.track(
                    self._slot, depth,
                    seed=(self._index == 0 or self._take_pending_seed()),
                    gray=gray, gen=self._gen,
                )
            except SessionDesyncError:
                self._desynced = True
                raise
            return self._append(r, ts)

    def process_window(self, depths, timestamps=None, window: int = 8,
                       grays=None) -> list[FrameResult]:
        """Run a frame batch, `min(window, executor window)` frames per
        device request (TrackingService /track_window plugs in here).
        Per-frame identical to `process` -- each chunk is one executor
        request whose frames batch across sessions AND scan along time
        (streams.step_streams_masked_window)."""
        if grays is not None:
            grays = [self._gray(g) for g in grays]
        if self._ex.config.rgbd and (
            grays is None or any(g is None for g in grays)
        ):
            raise ValueError(
                "rgbd executor: /track_window bodies need a 'grays' array "
                "with one intensity plane per frame"
            )
        with self._lock:
            self._check_sync()
            chunk = max(1, min(window, self._ex.config.window))
            out: list[FrameResult] = []
            for i in range(0, len(depths), chunk):
                arrs = [np.asarray(d) for d in depths[i : i + chunk]]
                kinds = {bool(np.issubdtype(a.dtype, np.integer))
                         for a in arrs}
                if len(kinds) > 1:
                    # Mixed raw-integer / float-meters chunks: np.asarray
                    # would promote the raw frames to float COUNTS that
                    # the step reads as meters. Convert the integer
                    # frames to meters at the executor's scale first.
                    from realsensetracker_tpu.data.depth_units import (
                        to_meters_np,
                    )

                    arrs = [to_meters_np(a, self._ex.config.depth_scale)
                            for a in arrs]
                part = np.asarray(arrs)
                if not np.issubdtype(part.dtype, np.integer):
                    part = part.astype(np.float32)  # raw u16 stays raw
                gpart = (np.stack(grays[i : i + chunk])
                         if grays is not None and self._ex.config.rgbd
                         else None)
                try:
                    rs = self._ex.track_window(
                        self._slot, part,
                        seed=(self._index == 0
                              or self._take_pending_seed()),
                        grays=gpart, gen=self._gen,
                    )
                except SessionDesyncError:
                    self._desynced = True
                    raise
                for j, r in enumerate(rs):
                    ts = (float(self._index) if timestamps is None
                          or timestamps[i + j] is None
                          else float(timestamps[i + j]))
                    out.append(self._append(r, ts))
            return out

    def _gray(self, color):
        """Color/gray plane -> [0, 1] f32 intensity (api.Tracker rules);
        None unless the executor is rgbd."""
        if not self._ex.config.rgbd:
            return None
        if color is None:
            return None  # executor raises its "needs intensity" error
        from realsensetracker_tpu.api.tracker import _as_gray

        return _as_gray(color)

    def _check_sync(self) -> None:
        if self._desynced:
            raise SessionDesyncError(
                "session is desynchronized from its device slot (an "
                "earlier frame timed out in-flight); reset the session"
            )

    def _take_pending_seed(self) -> bool:
        """Consume a drift-scheduled reseed (caller holds self._lock).
        The slot restarts from the incoming raw frame at identity; the
        anchor becomes the LAST composed world pose -- set here, not at
        drift detection, because frames between detection and reseed
        (the tail of a windowed chunk) still track in the OLD frame."""
        if not self._pending_seed:
            return False
        self._pending_seed = False
        self._anchor = self._pose_np.astype(np.float32)
        self._frames_since_seed = 0
        self.num_reseeds += 1
        return True

    def _probe(self) -> float:
        from realsensetracker_tpu.mapping.tsdf import TsdfConfig

        vc = self._ex.config.tsdf_cfg or TsdfConfig()
        return vc.resolution * vc.voxel_size / 4.0

    def _append(self, r: SlotResult, ts: float) -> FrameResult:
        """Caller holds self._lock."""
        pose = r.pose
        radius = self._ex.config.tsdf_submap_radius
        if radius > 0:
            pose = (self._anchor @ r.pose).astype(np.float32)
            self._frames_since_seed += 1
            # min-frames guard mirrors SubmapConfig.min_frames: a reseed
            # right after a reseed would thrash on a fast pan.
            if (r.success and not self._pending_seed
                    and self._frames_since_seed >= 4):
                from realsensetracker_tpu.mapping.submaps import pose_drifted

                if pose_drifted(r.pose, radius, self._probe()):
                    self._pending_seed = True  # anchor set at the reseed
        self._pose_np = pose
        self.trajectory.append(ts, pose)
        res = FrameResult(
            pose, r.relative, r.success, r.rmse,
            r.inlier_fraction, self._index,
        )
        self._index += 1
        return res

    def release(self) -> None:
        """Free the slot (called on /reset, or by GC as a fallback)."""
        self._ex._release_slot(self._slot, self._gen)

    def __del__(self):
        try:
            self.release()
        except Exception:
            pass
