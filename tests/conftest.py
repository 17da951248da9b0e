"""Test harness: the CPU, with an 8-device virtual mesh.

Tier-1 tests run on the CPU (`JAX_PLATFORMS=cpu`); sharding and halo
logic run on 8 virtual CPU devices.  Tests marked `gpu` need the card:
they take the `gpu_device` fixture, which skips them, with the reason,
where JAX finds no GPU.  On a machine with the card:

    JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/
"""

import os

import pytest

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_ENABLE_X64", "0")

import jax  # noqa: E402

if not os.environ.get("JAX_PLATFORMS"):
    jax.config.update("jax_platforms", "cpu")


@pytest.fixture
def gpu_device():
    """The first GPU; skips the test where there is none."""
    gpus = [d for d in jax.devices() if d.platform == "gpu"]
    if not gpus:
        pytest.skip(f"needs a GPU; JAX's backend is {jax.default_backend()}")
    return gpus[0]
