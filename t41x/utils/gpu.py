"""What the measurement entry points say about the card they ran on."""

from __future__ import annotations

import os
import subprocess

import jax


def require_gpu() -> jax.Device:
    """The first JAX device, which must be a GPU: a measurement that
    finds no card fails instead of timing the CPU."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"no GPU: JAX's first device is {dev.platform} "
                         f"({dev.device_kind})")
    return dev


def card_name_power() -> str:
    """`name, power.limit` of each card as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def describe() -> dict:
    """Device, precision and compiler settings of this process."""
    dev = jax.devices()[0]
    return {
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "device_count": len(jax.devices()),
        "matmul_precision": jax.config.jax_default_matmul_precision,
        "xla_flags": os.environ.get("XLA_FLAGS", ""),
    }
