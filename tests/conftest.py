"""Test configuration: run on CPU with 8 virtual devices (sharding tests)
and float64 enabled so math checks can use tight tolerances (the reference
C++ library is double-precision throughout).

The platform is JAX_PLATFORMS when it is set (the GPU run of the `chip`
tests sets JAX_PLATFORMS=cuda), else the CPU. `jax.config.update` after
import takes effect as long as no backend has been initialized yet — keep
this file free of jax array operations.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")
jax.config.update("jax_enable_x64", True)


@pytest.fixture(scope="session")
def gpu():
    """The first JAX device when it is a GPU; skips the test otherwise.
    Decided here, at run time, never while modules are collected."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX runs on {dev.platform}")
    return dev
