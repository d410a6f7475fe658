"""Multi-host utilities: dataset sharding across processes.

SURVEY.md section 5.8: scaling within a host is device sharding
(parallel/batched.py, sharded.py); across hosts the only traffic is
dataset distribution.
These helpers build globally-sharded frame batches from per-process local
data using jax.make_array_from_process_local_data -- each host loads only
its own shard of streams/pairs, and the global array spans the pod.

Single-process environments (tests, this container) degrade gracefully:
with one process the "global" batch is just the local one.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def global_frame_batch(
    local_frames: np.ndarray,  # (B_local, H, W) this process's frames
    mesh: Mesh,
    data_axis: str = "data",
) -> jax.Array:
    """Assemble a globally-sharded (B_global, H, W) batch from local shards."""
    sharding = NamedSharding(mesh, P(data_axis))
    return jax.make_array_from_process_local_data(sharding, np.asarray(local_frames))


def process_stream_slice(num_streams: int) -> slice:
    """Which stream indices this process owns (contiguous block split).

    num_streams must divide evenly across processes:
    make_array_from_process_local_data (global_frame_batch) requires every
    process to contribute an equal local batch -- a ceil split would give
    some processes fewer (or zero) streams and wedge/fail global assembly.
    """
    pid = jax.process_index()
    n = jax.process_count()
    if num_streams % n != 0:
        raise ValueError(
            f"num_streams={num_streams} must be a multiple of "
            f"process_count={n} (equal per-process shards required by "
            "global_frame_batch); pad the stream list to a multiple"
        )
    per = num_streams // n
    return slice(pid * per, (pid + 1) * per)


_barrier_calls = 0
_barrier_sum = None  # memoized jitted reduction (per-call jax.jit wrappers
# would re-trace and re-compile on every barrier)


def all_processes_ready() -> None:
    """Cross-host barrier: a reduction spanning EVERY device in the system.

    Each process contributes a ones-vector shard over its local devices; a
    jit'd sum with a replicated output sharding forces XLA to insert an
    all-reduce across the global mesh, which cannot complete until every
    process has enqueued it -- a true barrier. Blocks on device_get and
    verifies the contribution count. Single-process this degenerates to a
    local reduction over the local devices (cheap, still executed).
    """
    global _barrier_calls, _barrier_sum
    _barrier_calls += 1
    devices = np.array(jax.devices())  # all devices, all processes
    mesh = Mesh(devices, ("all",))
    sharding = NamedSharding(mesh, P("all"))
    # Each process contributes its barrier count, so the check below also
    # catches a process whose barrier calls have drifted from the others.
    local = np.full((len(jax.local_devices()),), float(_barrier_calls), np.float32)
    global_vals = jax.make_array_from_process_local_data(sharding, local)
    if _barrier_sum is None:
        _barrier_sum = jax.jit(
            jnp.sum, out_shardings=NamedSharding(mesh, P())
        )
    total = float(jax.device_get(_barrier_sum(global_vals)))
    if total != len(devices) * _barrier_calls:
        raise RuntimeError(
            f"barrier mismatch: {total} != {len(devices)} devices x call {_barrier_calls}"
        )
