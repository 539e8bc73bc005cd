"""Test configuration.

The suite runs on the CPU unless JAX_PLATFORMS says otherwise, with 8
virtual devices so that the multi-shard paths run without a multi-device
machine.  Tests marked ``gpu`` need a CUDA card and skip elsewhere; run
them on a card with
``JAX_PLATFORMS=cuda PYTHONPATH=. python -m pytest -o addopts="" -m gpu
tests/test_platform.py``.
"""

import os

import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if (os.environ["JAX_PLATFORMS"] == "cpu"
        and "xla_force_host_platform_device_count" not in flags):
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

from hyteg_tpu.core.compile_cache import enable_compile_cache  # noqa: E402

# Persistent XLA compilation cache: the suite rebuilds near-identical GMG
# stacks in many test files; caching compiled executables across tests and
# runs cuts total wall time several-fold.
enable_compile_cache()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.3)
jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)


@pytest.fixture
def gpu():
    """Skip unless JAX's default device is a CUDA GPU."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a CUDA GPU; JAX found {dev.platform}")
    return dev
