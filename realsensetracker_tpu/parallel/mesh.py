"""Device-mesh construction for multi-chip scaling.

The reference is a single-process, single-machine pipeline whose only
concurrency is one capture thread (rs_driver.cpp:136-225). This framework
scales across devices with a jax.sharding.Mesh of two logical axes:

* ``data``: independent frame pairs / streams (registrations are
  embarrassingly parallel -- SURVEY.md section 5.8);
* ``point``: sample points of a single registration, with jax.lax.psum of
  the 6x6 normal equations across the axis (parallel/sharded.py) -- the
  "tensor parallel" analog of this workload.
"""

from __future__ import annotations


import jax
import numpy as np
from jax.sharding import Mesh


def make_mesh(
    n_devices: int | None = None,
    data_axis: str = "data",
    point_axis: str = "point",
    point_parallelism: int = 1,
) -> Mesh:
    """Build a (data, point) mesh over the first n_devices devices."""
    devices = jax.devices()
    if n_devices is None:
        n_devices = len(devices)
    if n_devices > len(devices):
        raise ValueError(f"requested {n_devices} devices, have {len(devices)}")
    if n_devices % point_parallelism != 0:
        raise ValueError("point_parallelism must divide n_devices")
    grid = np.array(devices[:n_devices]).reshape(
        n_devices // point_parallelism, point_parallelism
    )
    return Mesh(grid, (data_axis, point_axis))


def balanced_mesh(n_devices: int | None = None) -> Mesh:
    """Mesh with point axis = 2 when device count allows, else pure data."""
    devices = jax.devices()
    if n_devices is None:
        n_devices = len(devices)
    pp = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    return make_mesh(n_devices, point_parallelism=pp)
