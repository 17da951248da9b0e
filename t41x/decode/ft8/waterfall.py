"""FT8 waterfall front end (JAX, device side).

Re-expression of the reference's FT8 DSP front end (`extract_power`,
tmr4/T41_SDR `ft8.cpp:223-256`): a log-power waterfall over the 15 s
receive slot with 2x oversampling in both time and frequency, feeding
the Costas sync search and soft-bit extraction.

Differences from the reference (deliberate, batch-first):
  * operates directly on the 24 kHz demodulated audio — no q15
    index-skip decimation to 6.4 kHz; the FFT length scales instead
    (3840-sample hop = 0.16 s; 7680-sample window = 2 symbols for the
    half-bin frequency oversampling)
  * float32 throughout; the waterfall stays in dB floats rather than
    the reference's byte quantization
  * all time slots are computed as ONE batched rFFT — the whole 15 s
    slot is a single (n_frames, fft) tensor op
  * RECTANGULAR symbol window, not the reference's Blackman
    (`ft_blackman_i` `ft8.cpp:168`): 6.25 Hz-spaced FSK tones are
    orthogonal over exactly one 0.16 s symbol, so the rectangular
    window IS the matched filter; Blackman triples the mainlobe and
    leaks tone energy into neighbor bins.  Measured (r5 sweep, 8
    trials/cell): decode rate at -18 dB SNR 6/8 rect vs 3/8 blackman,
    at -20 dB 2/8 vs 0/8 — ~1.5 dB of sensitivity — while the
    crowded-band envelope (15 signals over 16 dB of spread) stays
    15/15 with zero false decodes on all 3 seeds.

Output layout matches the reference indexing semantics:
power[slot, time_sub, freq_sub, bin] with bin spacing 6.25 Hz and
freq_sub selecting a 3.125 Hz half-bin offset.
"""

from __future__ import annotations

import jax.numpy as jnp

from t41x import constants as C
from t41x.dsp import dft

SYMBOL_SECONDS = 0.16
TONE_SPACING = 6.25
MAX_FREQ_HZ = 3200.0  # search span (reference: 368 bins * 6.25 = 2300)


def waterfall_shape(n_audio: int, rate: float = C.AUDIO_RATE):
    hop = int(round(SYMBOL_SECONDS * rate / 2))     # 0.08 s
    win = 2 * hop                                    # one symbol window
    n_frames = max((n_audio - 2 * win) // hop + 1, 0)
    n_slots = n_frames // 2
    n_bins = int(MAX_FREQ_HZ / TONE_SPACING)
    return n_slots, n_bins


def compute_waterfall(audio: jnp.ndarray, rate: float = C.AUDIO_RATE):
    """audio: (..., N) real audio at `rate`.

    Returns power (..., n_slots, 2, 2, n_bins) in dB — indexed like the
    reference's export_fft_power: [symbol slot, half-symbol time offset,
    half-bin freq offset, 6.25 Hz bin].
    """
    hop = int(round(SYMBOL_SECONDS * rate / 2))      # 1920 @ 24 kHz
    win = 2 * hop                                     # 3840 = 1 symbol
    fft_len = 2 * win                                 # zero-pad x2 for
    #                                                   3.125 Hz bins
    n = audio.shape[-1]
    n_frames = (n - win) // hop + 1
    idx = (jnp.arange(n_frames)[:, None] * hop
           + jnp.arange(win)[None, :])                # (F, win)
    frames = audio[..., idx]                          # (..., F, win)
    # rectangular window = the FSK matched filter (see module docstring)
    spec = dft.rfft(frames, n=fft_len, axis=-1)
    power = spec.real ** 2 + spec.imag ** 2
    db = 10.0 * jnp.log10(jnp.maximum(power, 1e-12))

    n_bins = int(MAX_FREQ_HZ / TONE_SPACING)
    # bin b (6.25 Hz) at freq_sub s (0 or 3.125 Hz offset):
    # fft bin index = 2*b + s  (fft resolution = rate/fft_len = 3.125 ...
    # only exact when rate = 24000)
    res = rate / fft_len
    scale = TONE_SPACING / res
    base = (jnp.arange(n_bins) * scale).astype(jnp.int32)
    half = int(round(TONE_SPACING / 2 / res))
    bins0 = db[..., base]                             # freq_sub 0
    bins1 = db[..., base + half]                      # freq_sub 1

    n_slots = n_frames // 2
    def regroup(x):
        x = x[..., : n_slots * 2, :]
        shp = x.shape[:-2] + (n_slots, 2, x.shape[-1])
        return x.reshape(shp)

    wf = jnp.stack([regroup(bins0), regroup(bins1)], axis=-2)
    # wf: (..., n_slots, 2[time_sub], 2[freq_sub], n_bins)
    return wf
