"""The one place that asks which device the program runs on.

* ``enable_compile_cache``: JAX's persistent compilation cache. An operator's
  ``JAX_COMPILATION_CACHE_DIR`` wins untouched; otherwise the cache lives at
  a fixed path inside the checkout (``.jax_cache/``, git-ignored), so a
  second process over the same code finds the first one's programs.
* ``require_gpu``: measurement and smoke entry points run on a GPU or fail;
  they never fall back to the CPU.
* ``describe``: platform, device kind and count as JAX reports them, plus
  the card's name and power limit as ``nvidia-smi`` reports them (a card
  set below its maximum power runs slower under load, so every number the
  program reports travels with it).
"""

from __future__ import annotations

import os
import shutil
import subprocess

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CACHE_DIR = os.path.join(REPO_ROOT, ".jax_cache")


def enable_compile_cache() -> str | None:
    """Point JAX's persistent compilation cache at ``CACHE_DIR`` unless
    ``JAX_COMPILATION_CACHE_DIR`` is set (then JAX reads it itself and this
    sets nothing). Call before the first compilation. Returns the directory
    set here, or None."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    import jax

    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    return CACHE_DIR


def require_gpu():
    """The first JAX device, which must be a GPU. Raises RuntimeError on
    any other platform (no CPU fallback)."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise RuntimeError(
            f"a GPU is required; JAX's first device is {dev.platform} "
            f"({dev.device_kind})")
    return dev


def nvidia_smi_name_and_power() -> str:
    """``nvidia-smi --query-gpu=name,power.limit`` for the first card, or a
    note saying why it could not be read."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return "nvidia-smi not found"
    try:
        out = subprocess.run(
            [exe, "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        ).stdout
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {type(e).__name__}"
    lines = out.strip().splitlines()
    return lines[0].strip() if lines else "nvidia-smi printed nothing"


def describe() -> dict:
    """JAX's view of the devices plus the card's name and power limit."""
    import jax

    devs = jax.devices()
    return {
        "platform": devs[0].platform,
        "kind": devs[0].device_kind,
        "count": len(devs),
        "nvidia_smi": nvidia_smi_name_and_power(),
    }
