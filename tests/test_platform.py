"""The one platform decision (utils.platform) and the compile-cache
location it gates (utils.jaxcache)."""

import os

import pytest

from barcoder_tpu.utils import jaxcache
from barcoder_tpu.utils import platform as plat


class _Dev:
    def __init__(self, platform):
        self.platform = platform


@pytest.mark.parametrize("name", ["gpu", "cpu"])
def test_known_platforms(name):
    assert plat.device_platform([_Dev(name)] * 2) == name


@pytest.mark.parametrize("name", ["rocm", "METAL", "neuron"])
def test_unknown_platform_raises(name):
    with pytest.raises(RuntimeError, match="unsupported JAX platform"):
        plat.device_platform([_Dev(name)])


def test_default_devices_are_the_cpu_here():
    assert plat.device_platform() == "cpu"


def test_tile_width_is_one_constant():
    """The sharded backend's mesh and tile come from the one module; the
    tile is the same on every platform (the H100 sweep found no effect)."""
    from barcoder_tpu.ops.scan import _sharded_mesh

    mesh, P = _sharded_mesh()
    assert P == plat.TILE_P == 2048
    assert mesh.devices.size == len(__import__("jax").devices())


def test_cache_dir_honours_the_environment(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert jaxcache.cache_dir() == str(tmp_path)


def test_cache_dir_default_is_fixed_inside_the_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert jaxcache.cache_dir() == os.path.join(repo, ".jax_cache")
    with open(os.path.join(repo, ".gitignore")) as fh:
        assert ".jax_cache/" in fh.read().split()


def _enable_with(monkeypatch, platform):
    """Run enable_compilation_cache as if on ``platform``, recording the
    config updates instead of applying them to this process."""
    import jax

    updates = {}
    monkeypatch.setattr(jaxcache, "_enabled", False)
    monkeypatch.setattr(plat, "device_platform", lambda devices=None: platform)
    monkeypatch.setattr(jax.config, "update", lambda k, v: updates.__setitem__(k, v))
    monkeypatch.setattr(jaxcache.os, "makedirs", lambda *a, **k: None)
    jaxcache.enable_compilation_cache()
    return updates


def test_cache_off_on_cpu(monkeypatch):
    monkeypatch.delenv("BARCODER_TPU_NO_CACHE", raising=False)
    assert _enable_with(monkeypatch, "cpu") == {}


def test_cache_on_gpu_sets_no_dir_when_env_names_one(monkeypatch, tmp_path):
    monkeypatch.delenv("BARCODER_TPU_NO_CACHE", raising=False)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    updates = _enable_with(monkeypatch, "gpu")
    assert "jax_compilation_cache_dir" not in updates
    assert updates["jax_persistent_cache_min_entry_size_bytes"] == 0


def test_cache_on_gpu_defaults_to_the_checkout_dir(monkeypatch):
    monkeypatch.delenv("BARCODER_TPU_NO_CACHE", raising=False)
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    updates = _enable_with(monkeypatch, "gpu")
    assert updates["jax_compilation_cache_dir"] == jaxcache.CHECKOUT_CACHE_DIR


def test_cache_disabled_by_env(monkeypatch):
    monkeypatch.setenv("BARCODER_TPU_NO_CACHE", "1")
    assert _enable_with(monkeypatch, "gpu") == {}
