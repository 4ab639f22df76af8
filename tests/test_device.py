"""The GPU guard and the compile-cache helper (utils/device.py)."""

from pathlib import Path

import jax
import pytest

from asr_decoder_tpu.utils import device


def test_require_gpu_raises_on_cpu(monkeypatch):
    cpus = jax.devices("cpu")
    monkeypatch.setattr(jax, "devices", lambda *a, **k: cpus)
    with pytest.raises(RuntimeError, match="needs a GPU"):
        device.require_gpu()


def test_device_info_reports_default_devices():
    info = device.device_info()
    devs = jax.devices()
    assert info == {"platform": devs[0].platform,
                    "kind": devs[0].device_kind, "count": len(devs)}


def test_compile_cache_env_var_wins(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert device.enable_compile_cache() == str(tmp_path)
    # JAX reads the variable itself: nothing else is set in code
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_default_is_fixed_inside_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        path = device.enable_compile_cache()
        checkout = Path(__file__).resolve().parents[1]
        assert Path(path) == checkout / ".jax_cache"
        assert device.enable_compile_cache() == path
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
