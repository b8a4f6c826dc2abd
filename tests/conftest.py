"""Test configuration: an 8-device virtual CPU mesh + fp64.

The tests run on the CPU (fp64 for parity with the fp64 Fortran
reference, 8 virtual devices for the sharding tests) unless
``JAX_PLATFORMS`` says otherwise, so that ``JAX_PLATFORMS=cuda,cpu`` runs
the ``gpu``-marked tests on a card.  The platform is fixed in-process
*before* any backend is initialized.
"""

import os

import pytest

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")
jax.config.update("jax_enable_x64", True)


@pytest.fixture
def gpu():
    """The first GPU; skips the test where JAX has none."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs a GPU (run with JAX_PLATFORMS=cuda,cpu on a "
                    "machine with one)")
    return dev
