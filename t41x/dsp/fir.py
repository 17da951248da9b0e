"""Stateful streaming FIR kernels (JAX).

Functional re-expressions of the CMSIS streaming FIR primitives the
reference leans on (`arm_fir_decimate_f32`, `arm_fir_interpolate_f32`,
`arm_fir_f32` — used in `Process.cpp:474-479,917-920`, `Exciter.cpp:87-150`):
pure `(state, block) -> (state, out)` functions whose state is the filter
history, so blocks chain bit-exactly and the same function can be scanned
over time, vmapped over channels, and shard_mapped over a mesh.

All kernels accept a leading batch (channel) axis; taps are real.
Complex inputs are filtered as two real streams (the taps are shared),
which XLA fuses into one conv.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def fir_state(taps: int, channels: tuple[int, ...] = (),
              dtype=np.float32) -> np.ndarray:
    """Zero history for a streaming FIR with `taps` coefficients.

    Returned as a host (numpy) array: state is a jit-function input,
    placed on the device by the call that consumes it."""
    return np.zeros(channels + (taps - 1,), np.dtype(dtype).name)


def _conv_valid_strided(x: jnp.ndarray, h_rev: jnp.ndarray,
                        stride: int) -> jnp.ndarray:
    """Batched 1-D valid correlation with stride: out[c, n] = sum_k
    x[c, n*stride + k] * h_rev[k]."""
    lhs = x[:, None, :]                      # (C, 1, L)
    rhs = h_rev[None, None, :]               # (1, 1, T)
    out = jax.lax.conv_general_dilated(
        lhs, rhs, window_strides=(stride,), padding="VALID",
        dimension_numbers=("NCH", "OIH", "NCH"),
        preferred_element_type=jnp.float32,
    )
    return out[:, 0, :]


def _apply_real(state, x, h, factor):
    taps = h.shape[0]
    xc = jnp.concatenate([state, x], axis=-1)         # (C, T-1+N)
    new_state = xc[..., -(taps - 1):] if taps > 1 else state
    xs = xc[..., factor - 1:]                          # first output window
    y = _conv_valid_strided(xs, h[::-1], factor)
    return new_state, y


def fir_decimate(state: jnp.ndarray, x: jnp.ndarray, h: jnp.ndarray,
                 factor: int):
    """Streaming FIR decimator (CMSIS `arm_fir_decimate_f32` semantics:
    causal filter over the continued stream, keeping every `factor`-th
    output, newest-sample phase).

    state: (..., T-1) history (same dtype/domain as x)
    x:     (..., N) block, N divisible by factor
    h:     (T,) real taps
    Returns (new_state, y) with y: (..., N // factor).
    """
    if jnp.iscomplexobj(x):
        sr, yr = fir_decimate(state.real, x.real, h, factor)
        si, yi = fir_decimate(state.imag, x.imag, h, factor)
        return sr + 1j * si, yr + 1j * yi
    squeeze = x.ndim == 1
    if squeeze:
        state, x = state[None], x[None]
    new_state, y = _apply_real(state, x, h, factor)
    if squeeze:
        new_state, y = new_state[0], y[0]
    return new_state, y


def fir_apply(state: jnp.ndarray, x: jnp.ndarray, h: jnp.ndarray):
    """Streaming FIR filter (decimation factor 1)."""
    return fir_decimate(state, x, h, 1)


def fir_interpolate(state: jnp.ndarray, x: jnp.ndarray, h: jnp.ndarray,
                    factor: int):
    """Streaming FIR interpolator (CMSIS `arm_fir_interpolate_f32`
    semantics: zero-stuff by `factor` then filter; no gain compensation —
    the caller scales by `factor` like the reference's DF* volume scale,
    `Process.cpp:929`).

    state: (..., ceil(T/factor)-1) history of *input-rate* samples
    x:     (..., N) block
    h:     (T,) taps, T divisible by factor
    Returns (new_state, y) with y: (..., N*factor).
    """
    if jnp.iscomplexobj(x):
        sr, yr = fir_interpolate(state.real, x.real, h, factor)
        si, yi = fir_interpolate(state.imag, x.imag, h, factor)
        return sr + 1j * si, yr + 1j * yi
    squeeze = x.ndim == 1
    if squeeze:
        state, x = state[None], x[None]
    taps = h.shape[0]
    assert taps % factor == 0, "interpolator taps must divide by factor"
    sub = taps // factor
    xc = jnp.concatenate([state, x], axis=-1)          # (C, sub-1+N)
    new_state = xc[..., -(sub - 1):] if sub > 1 else state
    # polyphase: y[n*L + p] = sum_m h[m*L + p] * x[n - m]
    hp = h.reshape(sub, factor)                         # h[m*L + p] = hp[m, p]
    lhs = xc[:, None, :]                                # (C, 1, L)
    rhs = hp[::-1].T[:, None, :]                        # (L, 1, sub) reversed
    out = jax.lax.conv_general_dilated(
        lhs, rhs, window_strides=(1,), padding="VALID",
        dimension_numbers=("NCH", "OIH", "NCH"),
        preferred_element_type=jnp.float32,
    )                                                   # (C, L, N)
    y = jnp.swapaxes(out, 1, 2).reshape(x.shape[0], -1)  # interleave phases
    if squeeze:
        new_state, y = new_state[0], y[0]
    return new_state, y


def decimate_reference(x: np.ndarray, h: np.ndarray, factor: int) -> np.ndarray:
    """NumPy oracle for tests: one-shot decimation of a zero-history
    stream with the same phase convention."""
    taps = len(h)
    xc = np.concatenate([np.zeros(taps - 1, x.dtype), x])
    n_out = len(x) // factor
    y = np.empty(n_out, dtype=np.result_type(x, h))
    for n in range(n_out):
        seg = xc[n * factor + factor - 1: n * factor + factor - 1 + taps]
        y[n] = np.dot(seg, h[::-1])
    return y
