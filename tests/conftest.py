"""Test configuration.

Multi-host logic is tested on CPU with a virtual 8-device mesh, per the project
test strategy (SURVEY.md section 4): the reference has no automated tests at all,
so this suite *is* the test pyramid for the framework.
"""
import os

# Run tests on CPU with 8 virtual devices so the sharding paths compile and
# execute without an accelerator — unless JAX_PLATFORMS is already set, as on
# a GPU host running the gpu-marked tests (JAX_PLATFORMS=cuda,cpu).  jax may
# already be imported when this runs (a sitecustomize can pre-import it), in
# which case env vars set here are too late — the config updates below are
# the reliable override.
_PLATFORMS = os.environ.get("JAX_PLATFORMS") or "cpu"
os.environ["JAX_PLATFORMS"] = _PLATFORMS
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", _PLATFORMS)
jax.config.update("jax_num_cpu_devices", 8)
# Physics validation wants float64 on CPU.
jax.config.update("jax_enable_x64", True)

# Persistent XLA compilation cache: the suite's wall time is dominated by
# recompiling the same transport/mesh programs every run; with a warm cache
# the full default run drops by an order of magnitude.  Safe across pytest-
# xdist workers (the cache layer uses atomic renames).
from mcrat_tpu.runtime import enable_compile_cache  # noqa: E402

enable_compile_cache()

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(42)


@pytest.fixture
def gpu():
    """The first GPU device; skips the test where JAX sees none.  On a GPU
    host: ``python -m pytest tests/ -m gpu -n 0`` (one process per card)."""
    device = jax.devices()[0]
    if device.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX's first device is {device.platform}")
    return device
