"""Profiling utilities.

The reference sprinkles cho::util::UTimer stopwatches through the hot path
(align_icp.cpp:81-93). Here: the same microsecond stopwatch for host code, a
per-stage aggregator for pipeline reports, and a jax.profiler trace helper
for real device profiling. JAX dispatch is async, so a device timing ends
with its outputs MATERIALIZED to host (or block_until_ready); benchmark
loops vary their input data per call (see bench.py).
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import jax
import numpy as np


class UTimer:
    """Microsecond stopwatch (cho::util::UTimer analog, align_icp.cpp:81)."""

    def __init__(self, start: bool = True):
        self._t0 = time.perf_counter() if start else None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop_and_get_elapsed_time(self) -> float:
        """Elapsed microseconds since start."""
        return (time.perf_counter() - self._t0) * 1e6


class StageTimes:
    """Accumulate named stage durations; report mean/total per stage."""

    def __init__(self):
        self._times = defaultdict(list)

    @contextlib.contextmanager
    def stage(self, name: str):
        """Time a stage. Yields a one-slot holder: append the stage's device
        outputs to it and they are MATERIALIZED to host before the clock
        stops::

            with times.stage("gn") as out:
                T, rmse = solve(...)
                out.append((T, rmse))
        """
        outputs: list = []
        t0 = time.perf_counter()
        yield outputs
        for x in outputs:
            jax.tree.map(np.asarray, x)
        self._times[name].append(time.perf_counter() - t0)

    def add(self, name: str, seconds: float) -> None:
        self._times[name].append(seconds)

    def report(self) -> dict:
        return {
            name: {
                "count": len(v),
                "mean_ms": 1e3 * sum(v) / len(v),
                "total_ms": 1e3 * sum(v),
            }
            for name, v in self._times.items()
        }


@contextlib.contextmanager
def device_trace(log_dir: str):
    """jax.profiler trace context -- open with TensorBoard / xprof."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
