"""Where the program runs: the GPU guard, the card's identity, and the
persistent compile cache.

Every entry point that measures or serves on the card (``chip_smoke.py``,
``bench.py``, ``eval.py``, the ``cli`` mains) calls ``enable_compile_cache``
before its first jit; the measuring ones call ``require_gpu`` so that a run
without a card fails instead of falling back to the CPU.
"""

from __future__ import annotations

import os
import subprocess
from pathlib import Path

import jax

REPO_ROOT = Path(__file__).resolve().parents[2]
CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compile cache; returns its directory.

    If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and no
    other directory is set here.  Otherwise the cache lives at the fixed
    ``<checkout>/.jax_cache`` (the path is part of the cache key, so it must
    not move between runs)."""
    env = os.environ.get(CACHE_ENV)
    if env:
        return env
    path = str(REPO_ROOT / ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def require_gpu() -> list:
    """``jax.devices()`` when they are GPUs; raises RuntimeError otherwise
    (no fallback to the CPU for anything that reports device numbers)."""
    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise RuntimeError(
            f"needs a GPU, but JAX's default devices are "
            f"{devices[0].platform!r} ({devices[0].device_kind})")
    return devices


def device_info() -> dict:
    """The default devices as JAX reports them."""
    devices = jax.devices()
    return {"platform": devices[0].platform,
            "kind": devices[0].device_kind,
            "count": len(devices)}


def gpu_name_and_power_limit() -> str:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``:
    one line per card, e.g. ``NVIDIA H100 80GB HBM3, 700.00 W``."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()
