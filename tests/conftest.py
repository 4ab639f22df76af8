"""Test harness: the CPU backend with 8 virtual devices, so the sharding
tests run without a card.

Tests marked ``gpu`` compare the card with the CPU backend and skip unless a
GPU is visible.  On a machine with a card, let JAX see it by setting the
platforms yourself: ``JAX_PLATFORMS=cuda,cpu python -m pytest tests/ -m gpu``.
"""

import os

import pytest

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("JAX_ENABLE_X64", "0")
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

from asr_decoder_tpu.utils.device import enable_compile_cache  # noqa: E402

# the suite is compile-dominated (large jitted search/session programs):
# repeat runs hit the persistent cache and skip recompiles
enable_compile_cache()
jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: long-running test (multi-process, big graphs)")
    config.addinivalue_line(
        "markers", "gpu: needs a GPU; compares it with the CPU backend")


@pytest.fixture(scope="session")
def gpu_device():
    """The first GPU, or a skip when JAX sees none."""
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("needs a GPU (run with JAX_PLATFORMS=cuda,cpu on a card)")
