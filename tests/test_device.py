"""utils/device: the compile-cache helper and the GPU requirement."""

import os

import jax
import pytest

from realsensetracker_tpu.utils import device


@pytest.fixture()
def cache_config():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_respects_env(monkeypatch, cache_config, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    jax.config.update("jax_compilation_cache_dir", None)
    assert device.enable_compile_cache() is None
    assert jax.config.jax_compilation_cache_dir is None


def test_compile_cache_fixed_path_in_checkout(monkeypatch, cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = device.enable_compile_cache()
    assert path == jax.config.jax_compilation_cache_dir
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert path == os.path.join(repo, ".jax_cache")
    # Same path on every call: no pid, time or temp dir in it.
    assert device.enable_compile_cache() == path


def test_cache_dir_is_git_ignored():
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(repo, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_require_gpu_refuses_cpu():
    with pytest.raises(RuntimeError, match="GPU is required"):
        device.require_gpu()


def test_describe_reports_devices_and_smi(monkeypatch):
    monkeypatch.setattr(device.shutil, "which", lambda name: None)
    info = device.describe()
    assert info["platform"] == "cpu"
    assert info["count"] == len(jax.devices())
    assert info["nvidia_smi"] == "nvidia-smi not found"
