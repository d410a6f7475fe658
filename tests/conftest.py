"""Test configuration: force CPU with 8 virtual devices (multi-chip sharding
tests without hardware) and enable x64 so covariance accumulation matches the
C++ reference's float64 (align_icp.cpp:37,125).

The persistent compilation cache is off here: CLI ``main()``s under test
call ``utils.device.enable_compile_cache``, and the tests must not leave
compiled CPU programs in the checkout. Tests that need a GPU carry the
``gpu`` marker and run their checks in a subprocess on the card
(tests/test_gpu.py).
"""

import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
jax.config.update("jax_enable_compilation_cache", False)


@pytest.fixture(scope="module", autouse=True)
def _fresh_compiler_state():
    """Clear JAX's compilation caches at every module boundary.

    XLA:CPU's LLVM JIT segfaults sporadically once ONE process has
    accumulated many hundreds of live compiled programs (observed twice at
    ~85% suite depth in test_tracking, stack = backend_compile_and_load;
    every crashing test passes standalone). Bounding the live-executable
    count per module keeps the single-process `pytest tests/` run stable;
    the cross-module recompiles this costs are small next to the heavy
    scan compiles each module owns anyway.
    """
    jax.clear_caches()
