"""Process-level settings shared by the entry points (cli, bench, chip_smoke).

Everything a run writes besides its outputs stays inside the checkout: the
JAX compile cache under ``.jax_cache/`` and work files (hot cross-section
tables, smoke-test runs) under ``.work/``, both listed in ``.gitignore``.
"""
from __future__ import annotations

import os

CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def compile_cache_dir() -> str:
    """``$JAX_COMPILATION_CACHE_DIR`` when set, else ``<checkout>/.jax_cache``."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        CHECKOUT, ".jax_cache"
    )


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at :func:`compile_cache_dir`.

    The path is fixed (no pid, time or temp dir): it is part of the cache key,
    so a run only hits what an earlier run in the same place compiled.
    Returns the directory in use.
    """
    import jax

    path = compile_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return path


def require_gpu(count: int = 1):
    """JAX's devices, or SystemExit unless the first is a GPU and ``count``
    are visible.  Measurement and smoke paths call this first: a run that
    finds no GPU fails instead of falling back to the CPU."""
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise SystemExit(f"needs a GPU, JAX found {devices[0].platform!r}")
    if len(devices) < count:
        raise SystemExit(f"needs {count} GPUs, found {len(devices)}")
    return devices


def card_info() -> str:
    """``name, power.limit`` per card from nvidia-smi (a child process that
    stays off JAX), one line per card."""
    import subprocess

    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


def work_dir(*parts: str) -> str:
    """``<checkout>/.work/<parts>``, created if missing."""
    path = os.path.join(CHECKOUT, ".work", *parts)
    os.makedirs(path, exist_ok=True)
    return path
