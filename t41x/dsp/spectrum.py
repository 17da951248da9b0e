"""Zoom-FFT spectrum / waterfall / S-meter (JAX).

Re-expression of the reference display DSP (tmr4/T41_SDR `FFT.cpp`):

  * `zoom1_spectrum` — zoom x1: Hann-windowed 512-pt FFT of the first
    512 I/Q samples of the block, halves swapped, EMA-smoothed
    (`CalcZoom1Magn`, `FFT.cpp:208-251`).
  * `ZoomFFT` — zoom 2^z: anti-alias IIR lowpass + FIR decimate by 2^z
    into a 512-sample ring, Hann window, 512-pt FFT, power, halves
    swapped, EMA (`ZoomFFTExe`, `FFT.cpp:67-196`; filter prep
    `ZoomFFTPrep`, `:35-55`).
  * `pixels_db` / `smeter_dbm` — log scaling to display pixels and the
    TCVSDR S-meter dBm formula (`Display.cpp:978-982`).

The waterfall is just the time-stacked pixel rows — it falls out of
`lax.scan` over blocks as a (n_blocks, ..., 512) tensor.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from t41x import constants as C
from t41x.dsp import dft, firdesign as fd, iir

RES = C.SPECTRUM_RES  # 512
EMA = 0.7             # spectrum temporal smoothing (FFT.cpp:171)


def _hann(n: int) -> np.ndarray:
    i = np.arange(n)
    # the reference uses cos(6.28 i / N) — keep the (slightly detuned)
    # 6.28 constant for parity (FFT.cpp:156-157)
    return (0.5 - 0.5 * np.cos(6.28 * i / n)).astype(np.float32)


def _swap_halves(p: jnp.ndarray) -> jnp.ndarray:
    return jnp.concatenate([p[..., RES // 2:], p[..., : RES // 2]], axis=-1)


def zoom1_spectrum(spec_old: jnp.ndarray, iq: jnp.ndarray):
    """Zoom x1 display spectrum from a (..., >=512) I/Q block.
    spec_old: (..., 512) EMA state.  Returns (spec_old', power)."""
    return zoom1_from_segment(spec_old, iq[..., :RES])


def zoom1_from_segment(spec_old: jnp.ndarray, seg: jnp.ndarray):
    """Zoom x1 tail from the first 512 I/Q samples of a block."""
    w = jnp.asarray(_hann(RES))
    spec = dft.fft(seg * w, axis=-1)
    power = _swap_halves(spec.real ** 2 + spec.imag ** 2)
    sm = EMA * power + (1.0 - EMA) * spec_old
    return sm, sm


class ZoomFFT:
    """Configured zoom-FFT front end for one zoom level (2^z)."""

    def __init__(self, zoom: int, rate: float = C.SAMPLE_RATE):
        assert 1 <= zoom <= 7
        self.zoom = zoom
        self.factor = 1 << zoom
        f_stop = 0.5 * rate / self.factor
        # 4-tap FIR decimator prototype, Astop 60 (ZoomFFTPrep FFT.cpp:41)
        self.h = fd.fir_kaiser(4, f_stop, 60.0, "lowpass",
                               fs=rate).astype(np.float32)
        # anti-alias IIR: same design family as the reference's baked
        # 4-stage biquads per zoom (mag_coeffs, FIR.cpp:582-885) —
        # 8th-order elliptic, 0.02 dB ripple, 60 dB stopband, -3 dB at
        # the decimated Nyquist; response parity vs the shipped tables
        # in tests/test_coeff_parity.py
        sos = fd.zoom_antialias_iir(zoom, fs=rate)
        self.iir_b = sos[:, :3].astype(np.float32)
        self.iir_a = sos[:, 3:].astype(np.float32)
        # chunk-parallel application at RF rate (16 matmuls, not a
        # 2048-step scan)
        self.iir_op = iir.BiquadChunked(self.iir_b, self.iir_a, chunk=128)
        # display scaling multiplier (FFT.cpp:148-151)
        self.multiplier = float(zoom if zoom <= 3 else self.factor)

    def init_state(self, channels: tuple[int, ...] = ()):
        return ZoomState(
            iir=np.zeros(channels + (2, self.iir_b.shape[0], 2), np.float32),
            dec=np.zeros(channels + (len(self.h) - 1,), np.complex64),
            ring=np.zeros(channels + (RES,), np.complex64),
            spec_old=np.zeros(channels + (RES,), np.float32),
        )

    def block(self, st: "ZoomState", iq: jnp.ndarray):
        """iq: (..., BLOCK) Fs/4-shifted I/Q.  Returns (state, power).

        Keeps a 512-sample ring of decimated samples; the FFT is taken
        over the most recent 512 (ring order handled by roll-free
        concatenation since sample counts are static).
        """
        st, x = self.prefilter(st, iq)
        return self.spectrum_from_decimated(st, x)

    def prefilter(self, st: "ZoomState", iq: jnp.ndarray):
        """Anti-alias IIR + decimate-by-2^zoom (the RF-rate half of the
        zoom tap).  Returns (state-with-new-iir/dec, decimated I/Q)."""
        from t41x.dsp import fir

        xi = jnp.stack([iq.real, iq.imag], axis=-2)  # (..., 2, N)
        iir_st, xi = self.iir_op.apply(st.iir, xi)
        x = (xi[..., 0, :] + 1j * xi[..., 1, :]).astype(jnp.complex64)
        dec_st, x = fir.fir_decimate(st.dec, x, jnp.asarray(self.h),
                                     self.factor)
        return ZoomState(iir_st, dec_st, st.ring, st.spec_old), x

    def spectrum_from_decimated(self, st: "ZoomState", x: jnp.ndarray):
        """Ring update + Hann/FFT/power/EMA over the decimated zoom
        stream (the audio/display-rate half of the zoom tap)."""
        n_new = x.shape[-1]
        if n_new >= RES:
            ring = x[..., -RES:]
        else:
            ring = jnp.concatenate([st.ring[..., n_new:], x], axis=-1)
        w = jnp.asarray(_hann(RES))
        spec = dft.fft(ring * (self.multiplier * w), axis=-1)
        power = _swap_halves(spec.real ** 2 + spec.imag ** 2)
        sm = EMA * power + (1.0 - EMA) * st.spec_old
        return ZoomState(st.iir, st.dec, ring, sm), sm


class ZoomState(NamedTuple):
    iir: jnp.ndarray
    dec: jnp.ndarray
    ring: jnp.ndarray
    spec_old: jnp.ndarray


def pixels_db(power: jnp.ndarray, db_scale: float = 10.0,
              base_offset: float = 0.0, pixel_offset: float = 0.0):
    """Spectrum power -> display pixel heights (FFT.cpp:185)."""
    return (base_offset + pixel_offset
            + db_scale * jnp.log10(jnp.maximum(power, 1e-30)))


def smeter_dbm(audio_max_squared_ave: np.ndarray,
               gain_correction: float = 0.0, attenuator: float = 0.0,
               rf_gain: float = 1.0, rf_gain_all: float = 0.0):
    """TCVSDR S-meter formula (reference `DrawSmeterBar`,
    `Display.cpp:978-982`): dbm = 22 + gainCorrection + attenuator
    + 10 log10(audioMaxSquaredAve) - 92 - RFgain*1.5 - rfGainAllBands.
    A host-side display formula (numpy): the live runner calls it on
    every block, where device dispatches would only add latency."""
    return (22.0 + gain_correction + attenuator
            + 10.0 * np.log10(np.maximum(audio_max_squared_ave, 1e-30))
            - 92.0 - rf_gain * 1.5 - rf_gain_all)
