"""Noise reduction algorithms (JAX).

Three NR algorithms + automatic notch, mirroring the reference's set
(tmr4/T41_SDR `Noise.cpp`):

  * `kim_nr` — Kim & Ruwisch 2002 spectral NR (`Kim1_NR`,
    `Noise.cpp:108-311`): 256-pt FFT frames, 50% overlap, Hann analysis,
    3-frame energy average, 15-frame minimum statistics, gain
    G = 1 - lambda/E clamped at 0, time + frequency smoothing,
    conjugate-symmetric mask, overlap-add.
  * `spectral_nr` — UHSDR spectral-subtraction NR
    (`SpectralNoiseReduction`, `Noise.cpp:379-645`): speech-presence
    probability, tracked noise estimate, a-priori/posteriori SNR,
    G = sqrt(0.7212 v + v^2)/SNR_post, musical-noise averaging,
    sqrt-Hann analysis+synthesis, overlap-add.
    NOTE: the reference nests its musical-noise pass inside the per-bin
    gain loop (an apparent scoping bug, `Noise.cpp:538-596` — the whole
    smoothing pass runs once per bin); t41x implements the intended
    algorithm: gains for all bins first, then ONE musical-noise pass.
  * `xanr` — WDSP variable-leak LMS predictor (`Xanr`,
    `Noise.cpp:322-370`): 64-tap adaptive filter over a 16-sample delay
    line; prediction output = NR, error output = automatic notch.

Frame/FFT ops are batched over channels; the LMS is a per-sample scan.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from t41x import constants as C
from t41x.dsp import dft

NR_FFT_L = 256
HOP = NR_FFT_L // 2  # 128


def _vad_bins(f_lo: float, f_hi: float, rate: float = C.AUDIO_RATE):
    """Voice-activity band limits in NR bins (reference
    `Noise.cpp:144-173`)."""
    if f_lo <= 0 and f_hi >= 0:
        lf, uf = 0.0, max(-f_lo, f_hi)
    elif f_lo > 0:
        lf, uf = f_lo, f_hi
    else:
        lf, uf = -f_hi, -f_lo
    bin_bw = rate / NR_FFT_L
    lo, hi = int(lf / bin_bw), int(uf / bin_bw)
    if lo == hi:
        hi += 1
    lo = min(max(lo, 1), HOP - 2)
    hi = min(max(hi, 1), HOP)
    return lo, hi


def _hann() -> np.ndarray:
    i = np.arange(NR_FFT_L)
    return (0.5 * (1.0 - np.cos(2.0 * np.pi * i / (NR_FFT_L - 1)))
            ).astype(np.float32)


def _sqrt_hann() -> np.ndarray:
    # periodic sqrt-Hann as tabulated in the reference (Noise.cpp:55-89,
    # endpoint-zero symmetric variant)
    i = np.arange(NR_FFT_L)
    return np.sqrt(0.5 * (1.0 - np.cos(2.0 * np.pi * i / (NR_FFT_L - 1)))
                   ).astype(np.float32)


# ----------------------------------------------------------------------
# Kim & Ruwisch 2002
# ----------------------------------------------------------------------

class KimParams(NamedTuple):
    alpha: float = 0.95    # time smoothing (gwv.cpp:62)
    beta: float = 0.85     # frequency smoothing (gwv.cpp:63)
    psi: float = 2.5       # min-statistics threshold (reference EEPROM
    #                        default is 0.0 which degenerates to lambda=M;
    #                        2.5 is the upstream Convolution-SDR value)
    vad_low: int = 1
    vad_high: int = HOP
    post_gain: float = 30.0  # Process.cpp:846 output scale


def kim_params(f_lo: float = 200.0, f_hi: float = 3000.0,
               **kw) -> KimParams:
    lo, hi = _vad_bins(f_lo, f_hi)
    return KimParams(vad_low=lo, vad_high=hi, **kw)


class KimState(NamedTuple):
    last_sample: jnp.ndarray   # (..., 128) input history
    last_ifft: jnp.ndarray     # (..., 128) overlap-add tail
    X: jnp.ndarray             # (..., 3, 128) power ring (order-free)
    E: jnp.ndarray             # (..., 15, 128) 3-frame-avg ring
    Gts: jnp.ndarray           # (..., 128) time-smoothed gain
    idx: jnp.ndarray           # (...,) int32 frame counter (ring cursor)


def kim_state(channels: tuple[int, ...] = ()) -> KimState:
    """Ring slots lead the bin axis ((..., slots, 128)) so each slot is
    a contiguous vector.  (Changed from (..., 128, slots): old
    DSP-state checkpoints fail to load with a clear shape error.)"""
    z = lambda *s: np.zeros(channels + s, np.float32)  # noqa: E731
    return KimState(z(HOP), z(HOP), z(3, HOP), z(15, HOP), z(HOP),
                    np.zeros(channels, np.int32))


def _kim_gain(p: KimParams, gst, power):
    """Per-hop gain update: (X, E, Gts, idx) x bin powers -> full gain.

    The X/E histories are RINGS, not shift registers: every consumer
    (mean, min) is permutation-invariant, so overwriting the oldest slot
    in place is sample-exact vs the reference's shifting
    (Noise.cpp:19-32) while avoiding two full-history rewrites per hop
    (the (C, 128, 15) shift-concat alone was ~31 MB/block of HBM traffic
    at 1024 channels).  All channels advance in lockstep, so one scalar
    cursor drives the dynamic-slice write."""
    X0, E0, Gts0, idx = gst
    cursor = idx.reshape(-1)[0]
    X = jax.lax.dynamic_update_index_in_dim(
        X0, power, jnp.mod(cursor, 3), axis=-2)
    E_new = jnp.mean(X, axis=-2)
    E = jax.lax.dynamic_update_index_in_dim(
        E0, E_new, jnp.mod(cursor, 15), axis=-2)
    M = jnp.min(E, axis=-2)

    T = power / jnp.maximum(M, 1e-30)
    lam = jnp.where(T > p.psi, M, E_new)
    G = jnp.maximum(1.0 - lam / jnp.maximum(E_new, 1e-30), 0.0)

    # the reference only computes gains inside the VAD band
    # (Noise.cpp:241-255); out-of-band gains stay at their zero init
    bins = jnp.arange(HOP)
    in_band = (bins >= p.vad_low) & (bins < p.vad_high)
    G = jnp.where(in_band, G, 0.0)

    Gts = p.alpha * Gts0 + (1.0 - p.alpha) * G

    # 3-bin frequency smoothing with edge handling (Noise.cpp:258-263)
    b, omb = p.beta, 1.0 - 2.0 * p.beta
    left = jnp.concatenate([Gts[..., :1], Gts[..., :-1]], axis=-1)
    right = jnp.concatenate([Gts[..., 1:], Gts[..., -1:]], axis=-1)
    Gs = b * left + omb * Gts + b * right
    return (X, E, Gts, idx + 1), Gs


def kim_nr(p: KimParams, st: KimState, x: jnp.ndarray):
    """x: (..., 256) audio block at 24 kHz.  Returns (state, y).

    Latency structure: the two overlapped hops' FORWARD transforms
    depend only on input samples (hop 2's frame IS the block), so both
    run as one batched matmul-DFT; the per-bin gain recursions chain
    sequentially (cheap VPU work); both INVERSE transforms batch again.
    Chaining fft->gain->ifft->fft->... per hop instead costs a
    dependent-matmul latency chain ~2x longer per block (measured +134
    -> +60 us at 1024 channels)."""
    window = jnp.asarray(_hann())
    frame0 = jnp.concatenate([st.last_sample, x[..., :HOP]], axis=-1)
    frames = jnp.stack([frame0 * window, x * window], axis=0)
    # half-spectrum transforms: real frames and real gain masks make
    # the upper 128 bins redundant — half the DFT matmul flops
    sr, si = dft.rdft_half(frames)              # (2, ..., 129)
    powers = (sr ** 2 + si ** 2)[..., :HOP]

    # NOTE lockstep invariant: _kim_gain drives its ring cursor from
    # channel 0's counter only — valid because every channel of a batch
    # advances one hop per call.  Do NOT merge per-channel states that
    # were stepped different numbers of times (e.g. restoring channels
    # from different checkpoints); re-init the Kim state instead.  The
    # ring consumers (mean/min) are order-free, so a common cursor of
    # any value is safe, only cross-channel divergence is not.
    gst, g0 = _kim_gain(p, (st.X, st.E, st.Gts, st.idx), powers[0])
    (X, E, Gts, idx), g1 = _kim_gain(p, gst, powers[1])
    gs = jnp.stack([g0, g1], axis=0)
    # Half-spectrum equivalent of the reference's mirror
    # (Noise.cpp:265-270 applies G[i] to bin i AND bin 255-i — an
    # off-by-one "conjugate" map): for a symmetric input spectrum the
    # paired bins k and n-k share the SAME basis term, so the exact
    # effective half-spectrum gain is the average (G[k]+G[k-1])/2 with
    # G[0] at DC and G[127] at Nyquist — bit-faithful to the full form.
    mid = 0.5 * (gs[..., 1:] + gs[..., :-1])
    fg = jnp.concatenate([gs[..., :1], mid, gs[..., HOP - 1: HOP]],
                         axis=-1)
    outs = dft.irdft_half_real(sr * fg, si * fg)
    a0 = outs[0][..., :HOP] + st.last_ifft
    a1 = outs[1][..., :HOP] + outs[0][..., HOP:]
    new_st = KimState(x[..., HOP:], outs[1][..., HOP:], X, E, Gts, idx)
    return new_st, jnp.concatenate([a0, a1], axis=-1) * p.post_gain


# ----------------------------------------------------------------------
# UHSDR spectral subtraction
# ----------------------------------------------------------------------

class SpectralParams(NamedTuple):
    alpha: float = 0.95
    asnr_db: float = 20.0
    vad_low: int = 1
    vad_high: int = HOP
    width: int = 4
    power_threshold: float = 0.4
    tinc: float = HOP / C.AUDIO_RATE
    tax: float = 0.0239
    tap: float = 0.05062
    psthr: float = 0.99
    pnsaf: float = 0.01
    pspri: float = 0.5
    psini: float = 0.5
    snr_prio_min_db: float = -20.0
    init_frames: int = 20


def spectral_params(f_lo: float = 200.0, f_hi: float = 3000.0,
                    **kw) -> SpectralParams:
    lo, hi = _vad_bins(f_lo, f_hi)
    return SpectralParams(vad_low=lo, vad_high=hi, **kw)


class SpectralState(NamedTuple):
    last_sample: jnp.ndarray  # (..., 128)
    last_ifft: jnp.ndarray    # (..., 128)
    xt: jnp.ndarray           # (..., 128) noise estimate
    pslp: jnp.ndarray         # (..., 128) smoothed speech probability
    hk_old: jnp.ndarray       # (..., 128)
    frames: jnp.ndarray       # (...,) int32 frame counter


def spectral_state(channels: tuple[int, ...] = ()) -> SpectralState:
    z = lambda v=0.0: np.full(channels + (HOP,), v, np.float32)  # noqa: E731
    return SpectralState(z(), z(), z(1e-6), z(0.5), z(1.0),
                         np.zeros(channels, np.int32))


def _spectral_gain(p: SpectralParams, gst, X):
    """Per-hop gain update: (xt, pslp, hk_old, frames) x bin powers ->
    (state', full_gain, initializing)."""
    xt_c, pslp_c, hk_old_c, frames_c = gst
    ax = np.exp(-p.tinc / p.tax)
    ap = np.exp(-p.tinc / p.tap)
    xih1 = 10.0 ** (p.asnr_db / 10.0)
    xih1r = 1.0 / (1.0 + xih1) - 1.0
    pfac = (1.0 / p.pspri - 1.0) * (1.0 + xih1)
    snr_prio_min = 10.0 ** (p.snr_prio_min_db / 20.0)

    initializing = frames_c[..., None] < p.init_frames
    # init phase: accumulate noise estimate over the first frames
    xt_init = xt_c + 0.05 * p.psini * X

    # running phase: speech-presence-probability noise tracking
    ph1y = 1.0 / (1.0 + pfac * jnp.exp(
        jnp.clip(xih1r * X / jnp.maximum(xt_c, 1e-30), -50.0, 50.0)))
    pslp = ap * pslp_c + (1.0 - ap) * ph1y
    ph1y = jnp.where(pslp > p.psthr, 1.0 - p.pnsaf, jnp.minimum(ph1y, 1.0))
    xtr = (1.0 - ph1y) * X + ph1y * xt_c
    xt_run = ax * xt_c + (1.0 - ax) * xtr

    xt = jnp.where(initializing, xt_init, xt_run)
    pslp = jnp.where(initializing, pslp_c, pslp)

    snr_post = jnp.clip(X / jnp.maximum(xt, 1e-30), snr_prio_min, 1000.0)
    snr_prio = jnp.maximum(
        p.alpha * hk_old_c + (1.0 - p.alpha) * jnp.maximum(snr_post - 1.0, 0.0),
        0.0)

    v = snr_prio * snr_post / (1.0 + snr_prio)
    G = jnp.sqrt(jnp.maximum(0.7212 * v + v * v, 0.0)) / snr_post
    hk_old = snr_post * G * G

    # musical-noise treatment: dynamic averaging window NN based on the
    # in-band power ratio (intended algorithm; see module docstring)
    bins = jnp.arange(HOP)
    in_band = (bins >= p.vad_low) & (bins < p.vad_high)
    pre = jnp.sum(jnp.where(in_band, X, 0.0), axis=-1)
    post = jnp.sum(jnp.where(in_band, G * G * X, 0.0), axis=-1)
    ratio = post / jnp.maximum(pre, 1e-30)
    nn_f = jnp.where(ratio > p.power_threshold, 0.0,
                     jnp.round(p.width * (1.0 - ratio / p.power_threshold)))

    # NN in {1,3,5,7,9}: select among box-filtered versions of G.  All
    # five widths come from ONE edge-padded cumsum (a width-nn centered
    # box over edge-replicated g is a cumsum difference; padding by 4
    # everywhere leaves the clamped edge values identical per width).
    gp = jnp.concatenate(
        [jnp.repeat(G[..., :1], 4, -1), G,
         jnp.repeat(G[..., -1:], 4, -1)], axis=-1)
    c = jnp.cumsum(gp, axis=-1)
    c = jnp.concatenate([jnp.zeros_like(c[..., :1]), c], axis=-1)

    def box(nn):
        off = 4 - nn // 2
        return (c[..., off + nn: off + nn + HOP] - c[..., off: off + HOP]
                ) / nn

    G3, G5, G7, G9 = (box(nn) for nn in (3, 5, 7, 9))
    nn_idx = jnp.clip(nn_f, 0, 4).astype(jnp.int32)[..., None]
    G_sm = jnp.where(
        nn_idx == 0, G, jnp.where(
            nn_idx == 1, G3, jnp.where(
                nn_idx == 2, G5, jnp.where(nn_idx == 3, G7, G9))))
    G = jnp.where(in_band, G_sm, G)
    return (xt, pslp, hk_old, frames_c + 1), G, initializing


def spectral_nr(p: SpectralParams, st: SpectralState, x: jnp.ndarray):
    """x: (..., 256) audio block.  Returns (state, y).

    Same latency structure as `kim_nr`: both hops' forward transforms
    batch into one matmul-DFT (hop 2's frame is the block itself), the
    per-bin gain recursions chain sequentially, and both inverse
    transforms batch again."""
    window = jnp.asarray(_sqrt_hann())
    frame0 = jnp.concatenate([st.last_sample, x[..., :HOP]], axis=-1)
    frames = jnp.stack([frame0 * window, x * window], axis=0)
    # half-spectrum transforms (see kim_nr): half the DFT matmul flops
    sr, si = dft.rdft_half(frames)
    powers = (sr ** 2 + si ** 2)[..., :HOP]

    gst, g0, init0 = _spectral_gain(
        p, (st.xt, st.pslp, st.hk_old, st.frames), powers[0])
    (xt, pslp, hk_old, frames_n), g1, init1 = _spectral_gain(
        p, gst, powers[1])

    gs = jnp.stack([g0, g1], axis=0)
    # reference-mirror half-spectrum gains (see kim_nr)
    mid = 0.5 * (gs[..., 1:] + gs[..., :-1])
    fg = jnp.concatenate([gs[..., :1], mid, gs[..., HOP - 1: HOP]],
                         axis=-1)
    outs = dft.irdft_half_real(sr * fg, si * fg) * window
    a0 = outs[0][..., :HOP] + st.last_ifft
    a1 = outs[1][..., :HOP] + outs[0][..., HOP:]
    # during init, pass audio through untouched
    a0 = jnp.where(init0, x[..., :HOP], a0)
    a1 = jnp.where(init1, x[..., HOP:], a1)
    new_st = SpectralState(x[..., HOP:], outs[1][..., HOP:], xt, pslp,
                           hk_old, frames_n)
    return new_st, jnp.concatenate([a0, a1], axis=-1)


def spectral_nr_batch(p: SpectralParams, st: SpectralState,
                      xs: jnp.ndarray):
    """EXACT batched form of B sequential `spectral_nr` calls: the hop
    frames depend only on the input, so one forward rDFT over all 2B hop
    frames, one sequential scan of the per-hop gain recursion (the only
    true dependency), one inverse rDFT + vectorized overlap-add.
    xs: (B, ..., 256).  Returns (state, (B, ..., 256))."""
    B = xs.shape[0]
    ch = xs.shape[1:-1]
    window = jnp.asarray(_sqrt_hann())
    halves = jnp.moveaxis(xs.reshape((B,) + ch + (2, HOP)), -2, 1)
    halves = halves.reshape((2 * B,) + ch + (HOP,))
    prev = jnp.concatenate([st.last_sample[None], halves[:-1]], axis=0)
    frames = jnp.concatenate([prev, halves], axis=-1) * window
    sr, si = dft.rdft_half(frames)
    powers = (sr ** 2 + si ** 2)[..., :HOP]

    def step(gst, pw):
        gst, g, init = _spectral_gain(p, gst, pw)
        return gst, (g, init)

    (xt, pslp, hk_old, frames_n), (gs, inits) = jax.lax.scan(
        step, (st.xt, st.pslp, st.hk_old, st.frames), powers)
    mid = 0.5 * (gs[..., 1:] + gs[..., :-1])
    fg = jnp.concatenate([gs[..., :1], mid, gs[..., HOP - 1: HOP]],
                         axis=-1)
    outs = dft.irdft_half_real(sr * fg, si * fg) * window
    second = jnp.concatenate([st.last_ifft[None], outs[:-1, ..., HOP:]],
                             axis=0)
    hops = outs[..., :HOP] + second
    hops = jnp.where(inits, halves, hops)   # init phase: passthrough
    audio = jnp.moveaxis(hops.reshape((B, 2) + ch + (HOP,)), 1, -2)
    audio = audio.reshape((B,) + ch + (2 * HOP,))
    new_st = SpectralState(xs[-1, ..., HOP:], outs[-1, ..., HOP:],
                           xt, pslp, hk_old, frames_n)
    return new_st, audio


# ----------------------------------------------------------------------
# WDSP variable-leak LMS (NR + autonotch)
# ----------------------------------------------------------------------

class XanrParams(NamedTuple):
    taps: int = 64
    delay: int = 16
    two_mu: float = 1e-4
    gamma: float = 0.1
    den_mult: float = 6.25e-10
    lidx_min: float = 120.0
    lidx_max: float = 200.0
    lincr: float = 1.0
    ldecr: float = 3.0
    notch: bool = False
    post_gain: float = 1.5  # Process.cpp:855


class XanrState(NamedTuple):
    dline: jnp.ndarray  # (..., taps+delay) delay line, newest first
    w: jnp.ndarray      # (..., taps) adaptive weights
    lidx: jnp.ndarray   # (...,)
    ngamma: jnp.ndarray


def xanr_state(p: XanrParams, channels: tuple[int, ...] = ()) -> XanrState:
    return XanrState(
        dline=np.zeros(channels + (p.taps + p.delay,), np.float32),
        w=np.zeros(channels + (p.taps,), np.float32),
        lidx=np.full(channels, 120.0, np.float32),
        ngamma=np.full(channels, 0.001, np.float32),
    )


def xanr(p: XanrParams, st: XanrState, x: jnp.ndarray):
    """Variable-leak LMS: x (..., N) real audio -> (state, y).

    y is the predictor output (NR mode) or prediction error (notch mode).

    Structure: the delay line is NOT carried through the sample scan
    — its contents are pure delayed input, so the whole block's
    regressor windows are slices of one precomputed [history | block]
    buffer (`dynamic_slice` per step).  The scan carries only the
    adaptive weights and leak state; per-step work is the inherent LMS
    dot + weight update.  Internally the regressor/weights are kept
    oldest-first (a fixed reversal of the reference's newest-first ring,
    invisible to the output since both the prediction dot and the weight
    update are elementwise-consistent); the carried `dline` field keeps
    the public newest-first convention.
    """
    T, D = p.taps, p.delay
    N = x.shape[-1]
    # oldest-first history || block: padded[T+D+j] = x[j]
    padded = jnp.concatenate([st.dline[..., ::-1], x], axis=-1)

    def step(s, inp):
        w, lidx, ngamma = s
        xn, n = inp
        # reg[k] = x[n - D - (T-1) + k]  (oldest-first window of T samples)
        reg = jax.lax.dynamic_slice_in_dim(padded, n + 1, T, axis=-1)
        y = jnp.sum(w * reg, axis=-1)
        sigma = jnp.sum(reg * reg, axis=-1)
        inv_sigp = 1.0 / (sigma + 1e-10)
        error = xn - y

        out = error if p.notch else y

        nel = jnp.abs(error * (1.0 - p.two_mu * sigma * inv_sigp))
        nev = jnp.abs(xn - (1.0 - p.two_mu * ngamma) * y
                      - p.two_mu * error * sigma * inv_sigp)
        # reference quirk (Noise.cpp:353-358): on nev<nel, lidx+lincr is
        # tried; if it would exceed max it clamps there, OTHERWISE lidx
        # moves by (lincr - ldecr) net, clamped at min
        over = (lidx + p.lincr) > p.lidx_max
        lidx_new = jnp.where(
            over, p.lidx_max,
            jnp.maximum(lidx + p.lincr - p.ldecr, p.lidx_min))
        lidx = jnp.where(nev < nel, lidx_new, lidx)
        ngamma = p.gamma * (lidx ** 4) * p.den_mult

        c0 = 1.0 - p.two_mu * ngamma
        c1 = p.two_mu * error * inv_sigp
        w = c0[..., None] * w + c1[..., None] * reg

        return (w, lidx, ngamma), out

    xs = (jnp.moveaxis(x, -1, 0), jnp.arange(N, dtype=jnp.int32))
    # carried weights are oldest-first internally; st.w is stored
    # newest-first for compatibility with the state layout
    (w_f, lidx_f, ngamma_f), ys = jax.lax.scan(
        step, (st.w[..., ::-1], st.lidx, st.ngamma), xs, unroll=4)
    new_dline = padded[..., -(T + D):][..., ::-1]
    new_st = XanrState(new_dline, w_f[..., ::-1], lidx_f, ngamma_f)
    return new_st, jnp.moveaxis(ys, 0, -1) * (1.0 if p.notch else p.post_gain)
