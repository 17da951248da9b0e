"""Persistent XLA compile cache for the entry points.

Where `JAX_COMPILATION_CACHE_DIR` is set, JAX keeps its cache there and
nothing here overrides it.  Otherwise the cache lives at one fixed path
inside the checkout, `.jax_cache/`, so that every process started from
the checkout finds what an earlier one compiled.
"""

from __future__ import annotations

import os
from pathlib import Path

import jax

CHECKOUT_CACHE = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable() -> str:
    """Turn the persistent compile cache on; returns its directory."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", str(CHECKOUT_CACHE))
    return str(CHECKOUT_CACHE)
