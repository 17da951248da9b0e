"""Time-block sharding with ppermute halo exchange (JAX).

The reference carries filter state between consecutive 2048-sample blocks
(overlap-save history `Process.cpp:498-522`, decimator states
`T41_SDR.ino:388-397`).  When a long capture is sharded in TIME across
devices — each device holding a contiguous segment — that carried state
becomes a halo: each device needs the last `halo` samples of its LEFT
neighbor's segment before filtering.  This is the SDR equivalent of
sequence parallelism, and the halo moves with a single `ppermute` per
step (SURVEY.md §5; NCCL between GPUs).

Used inside `shard_map` over a mesh axis `t`:

    seg_filtered = halo_exchange_filter(seg, taps/mask..., axis="t")

For 192 kHz/24 kHz chains the halo is ~300 samples (256 OS history +
decimator tails), thousands of times smaller than a segment — the
exchange is latency-, not bandwidth-, bound.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from t41x import constants as C


def left_halo(x: jnp.ndarray, halo: int, axis_name: str) -> jnp.ndarray:
    """Fetch the trailing `halo` samples of the left neighbor's segment.

    x: (..., N) this device's time segment (inside shard_map).
    Device 0 receives zeros (stream start).
    Returns (..., halo).
    """
    n = jax.lax.axis_size(axis_name)
    tail = x[..., -halo:]
    # send my tail to my right neighbor  (perm: src -> dst)
    perm = [(i, i + 1) for i in range(n - 1)]
    recv = jax.lax.ppermute(tail, axis_name, perm)
    idx = jax.lax.axis_index(axis_name)
    return jnp.where(idx == 0, jnp.zeros_like(recv), recv)


def sharded_fir_decimate(x: jnp.ndarray, h: jnp.ndarray, factor: int,
                         axis_name: str) -> jnp.ndarray:
    """Streaming FIR decimation of a time-sharded signal: identical output
    to the unsharded stream, with the (taps-1)-sample history arriving
    from the left neighbor via ppermute.

    x: (..., N) per-device segment, N divisible by factor.
    """
    from t41x.dsp import fir

    taps = h.shape[0]
    halo = taps - 1
    state = left_halo(x, halo, axis_name)  # (…, taps-1) — the fir state layout
    _, y = fir.fir_decimate(state, x, h, factor)
    return y


def sharded_os_filter(x: jnp.ndarray, mask: jnp.ndarray,
                      axis_name: str,
                      fft_length: int = C.FFT_LENGTH) -> jnp.ndarray:
    """Overlap-save filtering of a time-sharded stream: each device
    receives its left neighbor's last fft_length/2 samples as initial
    history, then scans its own blocks locally.

    x: (..., N) with N divisible by fft_length/2.
    """
    from t41x.dsp import osfilter

    half = fft_length // 2
    hist = left_halo(x, half, axis_name)
    nb = x.shape[-1] // half
    blocks = jnp.moveaxis(
        x.reshape(x.shape[:-1] + (nb, half)), -2, 0)

    def step(st, blk):
        st, y = osfilter.os_filter(st, blk, mask)
        return st, y

    _, ys = jax.lax.scan(step, hist, blocks)
    ys = jnp.moveaxis(ys, 0, -2)
    return ys.reshape(x.shape)
