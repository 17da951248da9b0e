"""Overlap-save fast-convolution band-pass filter (JAX).

The core filter of the RX chain (reference `Process.cpp:498-595`):
512-point complex FFT of [previous half | new half], complex multiply
with a precomputed frequency-domain mask, inverse FFT, keep the second
half.  State is the previous half-block of samples.

Two execution paths:

* `os_filter` — jnp.fft based (works everywhere, lets XLA pick its FFT).
* `os_filter_matmul` — the matmul form: because the mask multiply is
  diagonal in the DFT basis, the whole FFT->mask->iFFT->keep-half pipeline
  collapses into ONE dense complex matrix `M = (F^-1 diag(mask) F)[half:]`
  applied per block: `out = W @ xw`.  For thousands of channels this is a
  channel-batched (C, 512) x (512, 256) matmul — no FFT at all.  Both paths are numerically identical to within fp32 rounding.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from t41x import constants as C
from t41x.dsp import dft


def os_state(channels: tuple[int, ...] = (),
             fft_length: int = C.FFT_LENGTH) -> np.ndarray:
    """Zero history: the previous fft_length/2 complex samples (host
    array; see fir.fir_state)."""
    return np.zeros(channels + (fft_length // 2,), np.complex64)


def os_filter(state: jnp.ndarray, x: jnp.ndarray, mask: jnp.ndarray,
              return_spectrum: bool = False):
    """One overlap-save block.

    state: (..., F/2) previous samples
    x:     (..., F/2) new samples
    mask:  (F,) or (..., F) frequency-domain filter mask
    Returns (new_state, y[, spec]) where y: (..., F/2) filtered samples and
    spec: (..., F) |product|^2 audio spectrum tap (reference
    `Process.cpp:550-570`).
    """
    xw = jnp.concatenate([state, x], axis=-1)
    X = dft.fft(xw, axis=-1)
    Y = X * mask
    y = dft.ifft(Y, axis=-1)[..., xw.shape[-1] // 2:]
    if return_spectrum:
        return x, y.astype(jnp.complex64), jnp.abs(Y) ** 2
    return x, y.astype(jnp.complex64)


def os_matmul_operator(mask: np.ndarray) -> np.ndarray:
    """Precompute W such that out = xw @ W.T  ==  ifft(fft(xw)*mask)[F/2:].

    W = (F^-1 diag(mask) F)[F/2:, :], shape (F/2, F), complex64.
    Computed at trace time in float64.
    """
    F = len(mask)
    dft = np.fft.fft(np.eye(F))
    idft = np.conj(dft).T / F
    W = (idft * mask[None, :]) @ dft
    return W[F // 2:, :].astype(np.complex64)


def os_filter_matmul(state: jnp.ndarray, x: jnp.ndarray, W: jnp.ndarray):
    """Overlap-save block as a single complex matmul.

    W: (F/2, F) from `os_matmul_operator`.  out = xw @ W.T.
    """
    xw = jnp.concatenate([state, x], axis=-1)
    # complex matmul via 4 real matmuls (XLA does this internally for
    # complex dot; spelled out keeps fp32 accumulation explicit)
    y = xw @ W.T
    return x, y.astype(jnp.complex64)


def os_spectrum_operators(mask: np.ndarray):
    """Split-form operators that give the audio-spectrum tap from matmuls.

    Returns (F_op, W2, mask_sq):
      X    = xw @ F_op.T          — the full F-point DFT (one matmul)
      y    = X @ W2.T             — iFFT(mask * X)[F/2:]
      spec = |X|^2 * mask_sq      — the post-mask |Y|^2 audio-spectrum tap
                                    (reference `Process.cpp:550-570`)
    Matches `os_filter(..., return_spectrum=True)` to fp32 rounding
    while staying matmul-only (no FFT op).
    """
    F = len(mask)
    dft = np.fft.fft(np.eye(F))
    idft = np.conj(dft).T / F
    W2 = idft[F // 2:, :] * mask[None, :]
    mask_sq = (np.abs(mask.astype(np.complex128)) ** 2).astype(np.float32)
    return dft.astype(np.complex64), W2.astype(np.complex64), mask_sq


def os_filter_matmul_spectrum(state: jnp.ndarray, x: jnp.ndarray,
                              F_op: jnp.ndarray, W2: jnp.ndarray,
                              mask_sq: jnp.ndarray):
    """Overlap-save block + audio-spectrum tap as two complex matmuls.

    Returns (new_state, y, spec) like `os_filter(return_spectrum=True)`.
    """
    xw = jnp.concatenate([state, x], axis=-1)
    X = xw @ F_op.T
    y = X @ W2.T
    spec = (X.real ** 2 + X.imag ** 2) * mask_sq
    return x, y.astype(jnp.complex64), spec
