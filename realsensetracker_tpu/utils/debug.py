"""Debugging aides: NaN guards and numeric checking.

The reference scatters manual NaN checks through the pipeline
("NANI!?", align_gicp.cpp:146-154; NaN->0 in conversion, rs_driver.cpp:84-88;
RemoveNans). This framework handles NaNs structurally (masking +
finite-guards in solvers); these helpers add the debugging equivalents:
a context that turns on jax's global NaN checking, and an assert-finite
helper usable inside jit.
"""

from __future__ import annotations

import contextlib

import jax
import jax.numpy as jnp


@contextlib.contextmanager
def debug_nans(enable: bool = True):
    """Enable jax_debug_nans within a scope (raises where a NaN is produced)."""
    # NOTE: jax.config.read("jax_debug_nans") raises on flags that have a
    # contextmanager; the attribute is the supported read path.
    prev = jax.config.jax_debug_nans
    jax.config.update("jax_debug_nans", enable)
    try:
        yield
    finally:
        jax.config.update("jax_debug_nans", prev)


def check_finite(x, name: str = "value"):
    """jit-compatible finite check: prints through jax.debug when violated.

    Returns x unchanged (insertable into pipelines without effect).
    """
    bad = jnp.logical_not(jnp.all(jnp.isfinite(x)))

    def _report(_):
        jax.debug.print(
            "[check_finite] {name}: non-finite VALUES PRESENT", name=name,
            ordered=False,
        )
        return 0

    # Print ONLY on violation (an unconditional host callback would flood
    # logs and tax every frame of a hot pipeline it is inserted into).
    jax.lax.cond(bad, _report, lambda _: 0, 0)
    return x


def count_nonfinite(tree) -> dict:
    """Host-side audit: count non-finite elements per leaf of a pytree."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        import numpy as np

        arr = np.asarray(leaf)
        if arr.dtype.kind in "fc":
            out[jax.tree_util.keystr(path)] = int((~np.isfinite(arr)).sum())
    return out
