"""CW tone detection (JAX, device side).

Re-expression of the reference's CW receive processing
(tmr4/T41_SDR `DoCWReceiveProcessing` `CWProcessing.cpp:322-373`):
64-tap band-pass FIR at the 750 Hz sidetone -> cross-correlation against
a 750 Hz reference sine (max over all 511 lags, EMA-smoothed 0.7/0.3) x
Goertzel magnitude at 750 Hz (`goertzel_mag` `CWProcessing.cpp:830-857`)
-> combined coefficient -> binary keying decision (threshold 50).

The per-block binary envelope feeds the host-side adaptive Morse decoder
(t41x.decode.cw_text).  On the device the correlation is one matmul against a
bank of shifted reference sines and the Goertzel is a dot product (no
sequential recurrence needed — Goertzel IS the DFT bin).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from t41x import constants as C

TONE_HZ = 750.0
BLOCK = 256  # audio samples per block at 24 kHz
THRESHOLD = 50.0


def design_cw_fir(num_taps: int = 64, tone: float = TONE_HZ,
                  rate: float = C.AUDIO_RATE) -> np.ndarray:
    """Equiripple band-pass around the sidetone (the reference ships a
    fixed Park-McClellan design, `FIR.cpp:93-175`)."""
    from scipy import signal

    bands = [0, tone - 300, tone - 120, tone + 120, tone + 300, rate / 2]
    h = signal.remez(num_taps, bands, [0, 1, 0], fs=rate)
    return h.astype(np.float32)


def reference_sine(n: int = BLOCK, tone: float = TONE_HZ,
                   rate: float = C.AUDIO_RATE) -> np.ndarray:
    """750 Hz reference (8 whole cycles in 256 samples — `sineTone`,
    `Utility.cpp:66-83`)."""
    t = np.arange(n)
    return np.sin(2.0 * np.pi * tone * t / rate).astype(np.float32)


class CWDetector:
    """Trace-time configured detector; pure function over (state, audio)."""

    def __init__(self, tone: float = TONE_HZ, rate: float = C.AUDIO_RATE):
        self.h = design_cw_fir(tone=tone, rate=rate)
        self.ref = reference_sine(tone=tone, rate=rate)
        k = int(0.5 + BLOCK * tone / rate)
        w = 2.0 * np.pi * k / BLOCK
        n = np.arange(BLOCK)
        self.goertzel_cos = np.cos(w * n).astype(np.float32)
        self.goertzel_sin = np.sin(w * n).astype(np.float32)
        # correlation as matmul: all 511 lags of full cross-correlation
        # corr[l] = sum_n x[n] ref[n - l + 255]
        R = np.zeros((2 * BLOCK - 1, BLOCK), np.float32)
        for lag in range(2 * BLOCK - 1):
            shift = lag - (BLOCK - 1)
            for_n = np.arange(BLOCK)
            idx = for_n - shift
            valid = (idx >= 0) & (idx < BLOCK)
            R[lag, valid] = self.ref[idx[valid]]
        self.corr_matrix = R  # (511, 256)

    def init_state(self, channels: tuple[int, ...] = ()):
        return CWState(
            fir=np.zeros(channels + (len(self.h) - 1,), np.float32),
            ave_corr=np.zeros(channels, np.float32),
            peak=np.zeros(channels, np.float32),
        )

    def block(self, st: "CWState", audio: jnp.ndarray):
        """audio: (..., 256) demodulated CW audio at 24 kHz.
        Returns (state, keyed, combined) with keyed (...,) bool."""
        from t41x.dsp import fir

        fir_st, x = fir.fir_apply(st.fir, audio, jnp.asarray(self.h))
        corr = jnp.matmul(x, jnp.asarray(self.corr_matrix).T)  # (..., 511)
        corr_max = jnp.max(corr, axis=-1)
        ave_corr = 0.7 * corr_max + 0.3 * st.ave_corr

        real = jnp.einsum("...n,n->...", x, jnp.asarray(self.goertzel_cos))
        imag = jnp.einsum("...n,n->...", x, jnp.asarray(self.goertzel_sin))
        mag = jnp.sqrt(real * real + imag * imag) / (BLOCK / 2.0)

        combined = 10.0 * corr_max * 100.0 * mag
        # the reference keys on a fixed combined>50 threshold tuned to its
        # q15-scaled audio; t41x normalizes against a decaying peak
        # tracker so detection is level-independent, with the same
        # absolute floor
        peak = jnp.maximum(combined, st.peak * 0.995)
        keyed = (combined > 0.4 * peak) & (combined > THRESHOLD)
        return CWState(fir_st, ave_corr, peak), keyed, combined


class CWState(NamedTuple):
    fir: jnp.ndarray
    ave_corr: jnp.ndarray
    peak: jnp.ndarray
