"""The receive chain: a pure, jittable, channelized streaming pipeline.

Functional re-expression of the reference's `ProcessIQData`
(tmr4/T41_SDR `Process.cpp:70-944`) — the per-block hot path:

    q15->f32, RF gain, DC block, IQ correction, Fs/4 shift, NCO mix,
    x4 + x2 decimation, overlap-save band-pass, AGC, demod (USB/LSB/AM/
    SAM/NFM), EQ/NR hooks, x2 + x4 interpolation, volume

re-architected for a batched accelerator:

  * one pure function  block(params, state, iq) -> (state, outputs)
  * all per-channel state is an explicit pytree (`RxState`)
  * channels are a leading batch axis — `vmap`-free batching, every op
    is written batched so the same jitted graph serves 1 or 10_000
    channels and `shard_map` can split the channel axis over a mesh
  * mode selection is static (one compiled graph per mode), parameters
    like NCO frequency / gains are dynamic per-channel arrays
  * the display-driven control inversion of the reference
    (`Display.cpp:337-340`) is gone: the chain is driven by a scan over
    time blocks

Sizes follow the reference operating point: 2048 complex samples in at
192 kHz per block, 256 audio samples out at 24 kHz (or 2048 at 192 kHz
when output interpolation is enabled).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from t41x import constants as C
from t41x.demod import am as am_mod, cw as cw_mod, nfm as nfm_mod, sam as sam_mod
from t41x.dsp import agc as agc_mod
from t41x.dsp import eq as eq_mod
from t41x.dsp import fir, firdesign as fd, iir, nco, nr as nr_mod, osfilter
from t41x.dsp import spectrum as spectrum_mod

SSB_FAMILY = ("usb", "lsb", "ft8", "cw")
MODES = SSB_FAMILY + ("am", "sam", "nfm", "psk31")


@dataclasses.dataclass(frozen=True)
class ChainSpec:
    """Static chain configuration (one compiled graph per spec)."""
    mode: str = "usb"
    f_lo: float = 200.0        # band-pass low cut, Hz (audio domain)
    f_hi: float = 3000.0       # band-pass high cut, Hz
    agc_mode: int = 2          # 0 off / 1 long / 2 slow / 3 med / 4 fast
    agc_thresh_db: float = 20.0
    nfm_bw: float = 12000.0    # NFM decimator design BW (Filter.cpp:16)
    nr_mode: int = 0           # 0 off / 1 Kim / 2 spectral / 3 LMS
    nb_on: bool = False        # LPC impulse noise blanker
    cw_decode: bool = True     # CW tone detection taps (mode 'cw' only)
    cw_filter_index: int = 5   # 0..4 narrow audio LPF, 5 = off
    cw_tone_hz: float = 750.0
    notch_on: bool = False     # automatic notch (Xanr error output)
    eq_on: bool = False        # 14-band receive EQ
    spectrum_zoom: int = -1    # -1 off / 0 zoom x1 / 1..7 zoom x2^z
    interpolate_out: bool = True
    use_matmul_osfilter: bool = True
    agc_kernel: str | None = None  # None: lax.scan; "triton": the GPU
    #                                kernel; "interpret": that kernel in
    #                                the Pallas interpreter (tests)
    q15_input: bool = False    # ingest ADC q15 int16 (i, q) pairs
    spectrum_taps: bool = True  # emit audio-spectrum + S-meter taps
    clip_taps: bool = False    # emit ADC half/quarter-clip flags for
    #                            the digitizer auto-gain loop
    #                            (Codec_gain, Process.cpp:979-1027)
    sample_rate: float = C.SAMPLE_RATE
    fft_length: int = C.FFT_LENGTH

    def __post_init__(self):
        assert self.mode in MODES, self.mode
        if self.agc_kernel not in (None, "triton", "interpret"):
            raise ValueError(f"unknown AGC kernel {self.agc_kernel!r}")


class ChannelParams(NamedTuple):
    """Dynamic per-channel parameters (vary without recompiling).
    Scalars or (C,) arrays for a channel batch."""
    nco_freq: jnp.ndarray        # fine-tune NCO, Hz
    rf_gain_db: jnp.ndarray      # rfGainAllBands (dB, Process.cpp:117)
    band_gain: jnp.ndarray       # bands[].RFgain linear scale
    iq_amp: jnp.ndarray          # IQAmpCorrectionFactor
    iq_phase: jnp.ndarray        # IQPhaseCorrectionFactor
    volume: jnp.ndarray          # 0..100
    eq_gains: jnp.ndarray        # (..., 14) EQ band gains 0..1


def default_params(channels: tuple[int, ...] = (), nco_freq: float = 0.0,
                   volume: float = 50.0) -> ChannelParams:
    f = lambda v: np.full(channels, v, np.float32)  # noqa: E731
    return ChannelParams(f(nco_freq), f(0.0), f(1.0), f(1.0), f(0.0),
                         f(volume),
                         np.ones(channels + (eq_mod.NUM_BANDS,), np.float32))


class RxState(NamedTuple):
    """Carried DSP state between blocks (pytree; leading dims = channels)."""
    dc_bq: jnp.ndarray       # (..., 2, 1, 2) DC-block biquad state (I,Q)
    nco_phase: jnp.ndarray   # (...,)
    dec1: jnp.ndarray        # (..., T1-1) complex
    dec2: jnp.ndarray        # (..., T2-1) complex
    osf: jnp.ndarray         # (..., F/2) complex overlap-save history
    agc: agc_mod.AGCState
    am_bq: jnp.ndarray       # (..., 2, 2) AM DC-block + lowpass cascade
    sam: sam_mod.SAMState
    nfm_last: jnp.ndarray    # (...,) complex
    int1: jnp.ndarray        # (..., T/2-1) interpolation histories (real)
    int2: jnp.ndarray
    smeter_avg: jnp.ndarray  # (...,) audioMaxSquaredAve EMA
    nr: object               # NR state for the configured nr_mode (or ())
    cw: object               # CW detector state (or ())
    cw_lp: object            # CW narrow audio filter state (or ())
    notch: object            # Xanr notch state (or ())
    eq: object               # EQ biquad bank state (or ())
    zoom: object             # zoom-FFT state / zoom1 EMA (or ())


class RxChain:
    """Configured receive chain: holds the spec plus all trace-time
    filter designs, and exposes pure functions over (params, state, iq)."""

    def __init__(self, spec: ChainSpec = ChainSpec()):
        self.spec = spec
        lp = min(max(spec.f_hi, -spec.f_lo), 10_000.0)
        if spec.mode == "nfm":
            # NFM refits the decimators to the demod bandwidth
            # (Process.cpp:259, SetDecIntFilters(nfmFilterBW))
            h1 = fd.fir_kaiser(C.dec1_taps(), spec.nfm_bw, C.N_ATT,
                               "lowpass", fs=spec.sample_rate)
            h2 = fd.fir_kaiser(C.dec2_taps(), spec.nfm_bw, C.N_ATT,
                               "lowpass", fs=spec.sample_rate / C.DF1)
        else:
            h1 = fd.fir_kaiser(C.dec1_taps(), lp, C.N_ATT, "lowpass",
                               fs=spec.sample_rate)
            h2 = fd.fir_kaiser(C.dec2_taps(), lp, C.N_ATT, "lowpass",
                               fs=spec.sample_rate / C.DF1)
        self.h1 = h1.astype(np.float32)
        self.h2 = h2.astype(np.float32)

        i1, i2 = fd.interpolation_prototypes(lp)
        self.hi1 = i1.astype(np.float32)
        self.hi2 = i2.astype(np.float32)

        # overlap-save band-pass mask; for real post-demod signals (NFM)
        # the same mask shapes the audio
        mask = fd.bandpass_mask(spec.f_lo, spec.f_hi,
                                spec.sample_rate / C.DF, spec.fft_length)
        self.mask = mask.astype(np.complex64)
        self.os_W = osfilter.os_matmul_operator(mask)
        self.os_F, self.os_W2, self.os_mask_sq = \
            osfilter.os_spectrum_operators(mask)

        # DC-block biquad at RF rate (Process.cpp:127), applied chunk-
        # parallel: 16 matmuls per block instead of a 2048-step scan
        b, a = fd.dc_block_biquad()
        self.dc_b = np.asarray([b], np.float32)
        self.dc_a = np.asarray([a], np.float32)
        self.dc_op = iir.BiquadChunked(self.dc_b, self.dc_a, chunk=128)

        # AM audio lowpass — SetIIRCoeffs(FHiCut, 1.3, fs/DF)
        # (T41_SDR.ino:563) — fused with the one-pole DC removal into one
        # chunk-parallel 2-stage cascade
        bb, aa = fd.biquad_rbj(abs(spec.f_hi), 1.3, spec.sample_rate / C.DF,
                               "lowpass")
        self.am_b = np.asarray([bb], np.float32)
        self.am_a = np.asarray([aa], np.float32)
        self.am_op = iir.BiquadChunked(*am_mod.am_post_cascade(bb, aa),
                                       chunk=64)

        self.agc_params = agc_mod.agc_params(spec.agc_mode,
                                             spec.agc_thresh_db,
                                             spec.sample_rate / C.DF)
        self.sam_params = sam_mod.sam_params(rate=spec.sample_rate / C.DF)

        # SSB level adjust (Process.cpp:482-492)
        f_cut_khz = (-spec.f_lo if spec.mode == "lsb" else spec.f_hi) * 1e-3
        self.vol_scale = float(7.0874 * abs(f_cut_khz) ** -1.232)

        # optional post-demod stages
        self.kim_params = nr_mod.kim_params(spec.f_lo, spec.f_hi)
        self.spectral_nr_params = nr_mod.spectral_params(spec.f_lo, spec.f_hi)
        self.xanr_params = nr_mod.XanrParams(notch=False)
        self.notch_params = nr_mod.XanrParams(notch=True)
        self.eq = eq_mod.EQDesign(spec.sample_rate / C.DF) if spec.eq_on else None
        self.cw = (cw_mod.CWDetector(spec.cw_tone_hz, spec.sample_rate / C.DF)
                   if spec.mode == "cw" and spec.cw_decode else None)
        if spec.mode == "cw" and spec.cw_filter_index < 5:
            # selectable narrow CW audio low-pass: same family as the
            # reference's five shipped designs (FIR.cpp:15-66, applied
            # Process.cpp:882-912) — 12-pole Chebyshev I, 0.02 dB ripple,
            # -3 dB at 840/1080/1320/1800/2000 Hz; response-parity vs the
            # shipped tables in tests/test_coeff_parity.py
            sos = fd.cw_audio_lpf(
                fd.CW_FILTER_FC_HZ[spec.cw_filter_index],
                fs=spec.sample_rate / C.DF)
            self.cw_lp_b = sos[:, :3].astype(np.float32)
            self.cw_lp_a = sos[:, 3:].astype(np.float32)
            self.cw_lp_op = iir.BiquadChunked(self.cw_lp_b, self.cw_lp_a,
                                              chunk=64)
        else:
            self.cw_lp_b = None
        self.zoomfft = (spectrum_mod.ZoomFFT(spec.spectrum_zoom,
                                             spec.sample_rate)
                        if spec.spectrum_zoom >= 1 else None)

    # ------------------------------------------------------------------
    def init_state(self, channels: tuple[int, ...] = ()) -> RxState:
        return RxState(
            dc_bq=np.zeros(channels + (2, 1, 2), np.float32),
            nco_phase=np.zeros(channels, np.float32),
            dec1=fir.fir_state(len(self.h1), channels, np.complex64),
            dec2=fir.fir_state(len(self.h2), channels, np.complex64),
            osf=osfilter.os_state(channels, self.spec.fft_length),
            agc=agc_mod.agc_state(self.agc_params, channels),
            am_bq=iir.biquad_state(channels, stages=2),
            sam=sam_mod.sam_state(channels),
            nfm_last=np.zeros(channels, np.complex64),
            int1=np.zeros(channels + (len(self.hi1) // C.DF2 - 1,),
                          np.float32),
            int2=np.zeros(channels + (len(self.hi2) // C.DF1 - 1,),
                          np.float32),
            smeter_avg=np.zeros(channels, np.float32),
            cw=(self.cw.init_state(channels) if self.cw else ()),
            cw_lp=(iir.biquad_state(channels, self.cw_lp_b.shape[0])
                   if self.cw_lp_b is not None else ()),
            nr=(nr_mod.kim_state(channels) if self.spec.nr_mode == 1 else
                nr_mod.spectral_state(channels) if self.spec.nr_mode == 2
                else nr_mod.xanr_state(self.xanr_params, channels)
                if self.spec.nr_mode == 3 else ()),
            notch=(nr_mod.xanr_state(self.notch_params, channels)
                   if self.spec.notch_on else ()),
            eq=(self.eq.init_state(channels) if self.spec.eq_on else ()),
            zoom=(self.zoomfft.init_state(channels) if self.zoomfft
                  else np.zeros(channels + (spectrum_mod.RES,), np.float32)
                  if self.spec.spectrum_zoom == 0 else ()),
        )

    # ------------------------------------------------------------------
    def block(self, params: ChannelParams, state: RxState, iq: jnp.ndarray):
        """Process one block.

        iq: (..., BLOCK) complex64 at the RF rate — or, with
        spec.q15_input, a pair of int16 arrays (i, q) in the reference's
        ADC q15 format (Process.cpp:102-111 arm_q15_to_float), which
        halves the ingest bytes of the dominant HBM stream.
        Returns (new_state, outputs: dict).
        """
        x, outputs, fe_upd = self._front(params, state, iq)
        return self._post_frontend(params, state, x, outputs, fe_upd)

    def _front(self, params, state, iq):
        """RF-rate front end (gain/DC/IQ/display taps/Fs4/NCO/decimate);
        returns (x at 24 kHz, outputs, front-end state updates)."""
        spec = self.spec
        outputs = {}

        if spec.clip_taps:
            # ADC clip statistics on the RAW samples, pre-gain (the
            # reference's UHSDR-heritage half_clip/quarter_clip flags
            # feeding Codec_gain, Process.cpp:979-1027): half scale and
            # quarter scale of the converter range, per channel
            if spec.q15_input:
                i16, q16 = iq
                mag = jnp.maximum(jnp.abs(i16.astype(jnp.int32)),
                                  jnp.abs(q16.astype(jnp.int32)))
                outputs["adc_half_clip"] = jnp.any(mag >= 16384, axis=-1)
                outputs["adc_quarter_clip"] = jnp.any(mag >= 8192,
                                                      axis=-1)
            else:
                mag = jnp.maximum(jnp.abs(iq.real), jnp.abs(iq.imag))
                outputs["adc_half_clip"] = jnp.any(mag >= 0.5, axis=-1)
                outputs["adc_quarter_clip"] = jnp.any(mag >= 0.25,
                                                      axis=-1)

        if spec.q15_input:
            i16, q16 = iq
            iq = ((i16.astype(jnp.float32) + 1j * q16.astype(jnp.float32))
                  * jnp.float32(1.0 / 32768.0)).astype(jnp.complex64)

        # --- front end: RF gain, DC block, IQ correction ----------------
        g = (10.0 ** (params.rf_gain_db / 20.0) * params.band_gain
             ).astype(jnp.float32)
        x = iq * g[..., None]

        xi = jnp.stack([x.real, x.imag], axis=-2)        # (..., 2, N)
        dc_bq, xi = self.dc_op.apply(state.dc_bq, xi)
        i_part, q_part = xi[..., 0, :], xi[..., 1, :]

        x = iq_correction(i_part, q_part, params.iq_amp, params.iq_phase)

        # --- RF spectrum taps (display path) -----------------------------
        zoom_state = state.zoom
        if spec.spectrum_zoom == 0:
            # zoom x1 uses the un-shifted data (Process.cpp:185-187)
            zoom_state, rf_spec = spectrum_mod.zoom1_spectrum(zoom_state, x)
            outputs["rf_spectrum"] = rf_spec

        # --- frequency translation --------------------------------------
        x = nco.fs4_shift(x)
        if self.zoomfft is not None:
            # zoom x2^z uses the Fs/4-shifted data (Process.cpp:212-215)
            zoom_state, rf_spec = self.zoomfft.block(zoom_state, x)
            outputs["rf_spectrum"] = rf_spec
        nco_phase, x = nco.nco_mix(state.nco_phase, x, params.nco_freq,
                                   spec.sample_rate)

        # --- decimation x4 then x2 --------------------------------------
        dec1, x = fir.fir_decimate(state.dec1, x, jnp.asarray(self.h1),
                                   C.DF1)
        dec2, x = fir.fir_decimate(state.dec2, x, jnp.asarray(self.h2),
                                   C.DF2)
        # x: (..., 256) complex at 24 kHz
        return x, outputs, dict(dc_bq=dc_bq, nco_phase=nco_phase,
                                dec1=dec1, dec2=dec2, zoom=zoom_state)

    def _post_frontend(self, params, state, x, outputs, fe_upd):
        """Audio-rate tail of the chain (filter/AGC/demod/NR/interp)."""
        upd, audio, outputs = self._tail_pre_nr(params, state, x, outputs)
        upd.update(fe_upd)
        nr_state, audio = self._apply_nr(state.nr, audio)
        upd["nr"] = nr_state
        return self._tail_post_nr(params, state._replace(**upd), audio,
                                  outputs)

    def _apply_nr(self, nr_state, audio):
        """Per-block noise reduction (Process.cpp:841-858); see
        `block_batch` for the cross-block batched form."""
        spec = self.spec
        if spec.nr_mode == 1:
            return nr_mod.kim_nr(self.kim_params, nr_state, audio)
        if spec.nr_mode == 2:
            return nr_mod.spectral_nr(self.spectral_nr_params, nr_state,
                                      audio)
        if spec.nr_mode == 3:
            return nr_mod.xanr(self.xanr_params, nr_state, audio)
        return nr_state, audio

    def _tail_pre_nr(self, params, state, x, outputs):
        """Filter/AGC/demod/EQ — the audio-rate tail UP TO the NR
        stage.  Returns (state-field updates, audio, outputs)."""
        spec = self.spec
        sam_state = state.sam
        am_bq = state.am_bq
        nfm_last = state.nfm_last
        agc_state = state.agc
        osf = state.osf
        smeter_avg = state.smeter_avg

        spectrum = None
        if spec.mode in SSB_FAMILY + ("am", "sam"):
            x = x * self.vol_scale
            if spec.use_matmul_osfilter:
                if spec.spectrum_taps:
                    # split-form operators: the spectrum tap comes out of
                    # the same matmuls as the filtered block
                    osf, y, spectrum = osfilter.os_filter_matmul_spectrum(
                        osf, x, jnp.asarray(self.os_F),
                        jnp.asarray(self.os_W2),
                        jnp.asarray(self.os_mask_sq))
                else:
                    osf, y = osfilter.os_filter_matmul(
                        osf, x, jnp.asarray(self.os_W))
            else:
                osf, y, spectrum = osfilter.os_filter(
                    osf, x, jnp.asarray(self.mask), return_spectrum=True)
            agc_state, y = agc_mod.agc_apply(self.agc_params, agc_state, y,
                                             kernel=spec.agc_kernel)
            if spec.mode in SSB_FAMILY:
                audio = y.real
            elif spec.mode == "am":
                am_bq, audio = am_mod.am_demod(am_bq, y, self.am_op)
            else:  # sam
                sam_state, audio, carrier = sam_mod.sam_demod(
                    self.sam_params, sam_state, y)
                outputs["sam_carrier_hz"] = carrier
        elif spec.mode == "nfm":
            nfm_last, audio = nfm_mod.nfm_demod(nfm_last, x)
            # post-demod audio shaping: OS filter + AGC on the real audio
            # (Process.cpp:765-816)
            ac = audio.astype(jnp.complex64)
            if spec.use_matmul_osfilter and spec.spectrum_taps:
                osf, y, spectrum = osfilter.os_filter_matmul_spectrum(
                    osf, ac, jnp.asarray(self.os_F), jnp.asarray(self.os_W2),
                    jnp.asarray(self.os_mask_sq))
            elif spec.use_matmul_osfilter:
                osf, y = osfilter.os_filter_matmul(
                    osf, ac, jnp.asarray(self.os_W))
                spectrum = None
            else:
                osf, y, spectrum = osfilter.os_filter(
                    osf, ac, jnp.asarray(self.mask), return_spectrum=True)
            agc_state, y = agc_mod.agc_apply(self.agc_params, agc_state, y,
                                             kernel=spec.agc_kernel)
            audio = y.real
        else:  # psk31: decimated I/Q is the product; audio is the real part
            audio = x.real
            outputs["iq_baseband"] = x

        if spectrum is not None and spec.spectrum_taps:
            outputs["audio_spectrum"] = spectrum
            peak = jnp.max(spectrum, axis=-1)
            smeter_avg = 0.5 * peak + 0.5 * smeter_avg
            outputs["smeter_avg"] = smeter_avg

        # --- receive EQ (Process.cpp:828-831) ----------------------------
        eq_state = state.eq
        if spec.eq_on:
            eq_state, audio = self.eq.apply(eq_state, audio, params.eq_gains)

        return (dict(osf=osf, agc=agc_state, am_bq=am_bq, sam=sam_state,
                     nfm_last=nfm_last, smeter_avg=smeter_avg,
                     eq=eq_state), audio, outputs)

    def _tail_post_nr(self, params, state, audio, outputs):
        """Notch/blanker/CW/interp/volume — the audio-rate tail AFTER
        the NR stage.  `state` carries current values for every field;
        only the post-NR fields are replaced."""
        spec = self.spec

        # --- automatic notch (Process.cpp:862-866) -----------------------
        notch_state = state.notch
        if spec.notch_on:
            notch_state, audio = nr_mod.xanr(self.notch_params, notch_state,
                                             audio)

        # --- noise blanker (Process.cpp:873-876) -------------------------
        if spec.nb_on:
            from t41x.dsp import nb as nb_mod
            audio = nb_mod.noise_blanker(audio)

        # --- CW processing (Process.cpp:878-913) -------------------------
        cw_state, cw_lp_state = state.cw, state.cw_lp
        if self.cw is not None:
            cw_state, keyed, combined = self.cw.block(cw_state, audio)
            outputs["cw_keyed"] = keyed
            outputs["cw_combined"] = combined
        if self.cw_lp_b is not None:
            cw_lp_state, audio = self.cw_lp_op.apply(cw_lp_state, audio)

        outputs["audio_24k"] = audio

        # --- interpolation back to 192 kHz + volume ----------------------
        int1, int2 = state.int1, state.int2
        if spec.interpolate_out:
            int1, a = fir.fir_interpolate(int1, audio, jnp.asarray(self.hi1),
                                          C.DF2)
            int2, a = fir.fir_interpolate(int2, a, jnp.asarray(self.hi2),
                                          C.DF1)
            vol = volume_to_amplification(params.volume)[..., None]
            outputs["audio"] = a * (C.DF * vol)
        else:
            vol = volume_to_amplification(params.volume)[..., None]
            outputs["audio"] = audio * vol

        new_state = state._replace(int1=int1, int2=int2, cw=cw_state,
                                   cw_lp=cw_lp_state, notch=notch_state)
        return new_state, outputs

    # ------------------------------------------------------------------
    def block_batch(self, params, state, blocks):
        """Process (B, ..., BLOCK) blocks in ONE call — semantics
        identical to scanning `block`, with the NR stage batched across
        blocks when the algorithm allows.

        The spectral-NR hop frames depend only on the raw input halves,
        so a B-block batch can run as: scan(front end +
        filter/AGC/demod/EQ) -> ONE batched NR (2B hop transforms as
        one DFT batch) -> scan(notch/CW/interp).  Kim and LMS NR keep
        their per-block form inside one scan.  Returns (state, outputs)
        with outputs stacked on a leading (B,) axis.
        """
        spec = self.spec

        if spec.nr_mode != 2:
            def step(st, blk):
                return self.block(params, st, blk)

            return jax.lax.scan(step, state, blocks)

        # each scan carries ONLY the fields its stage mutates — the NR
        # rings (9.4 MB at 1024 ch) and post-NR states must not thread
        # through a scan that never touches them
        pre_f = ("dc_bq", "nco_phase", "dec1", "dec2", "zoom", "osf",
                 "agc", "am_bq", "sam", "nfm_last", "smeter_avg", "eq")
        post_f = ("notch", "cw", "cw_lp", "int1", "int2")

        def pre(carry, blk):
            st, audio, outs = self._block_pre_nr(
                params, state._replace(**carry), blk)
            return {f: getattr(st, f) for f in pre_f}, (audio, outs)

        carry, (audio, outs) = jax.lax.scan(
            pre, {f: getattr(state, f) for f in pre_f}, blocks)
        nr_state, audio = nr_mod.spectral_nr_batch(
            self.spectral_nr_params, state.nr, audio)

        def post(pcarry, inp):
            audio_b, outs_b = inp
            st, o = self._tail_post_nr(
                params, state._replace(**pcarry), audio_b, outs_b)
            return {f: getattr(st, f) for f in post_f}, o

        pcarry, outs2 = jax.lax.scan(
            post, {f: getattr(state, f) for f in post_f}, (audio, outs))
        final = state._replace(nr=nr_state, **carry, **pcarry)
        return final, outs2

    def _block_pre_nr(self, params, state, iq):
        """One block through the front end and the pre-NR tail; returns
        (state-with-pre-fields-updated, audio, outputs)."""
        x, outputs, fe_upd = self._front(params, state, iq)
        upd, audio, outputs = self._tail_pre_nr(params, state, x, outputs)
        upd.update(fe_upd)
        return state._replace(**upd), audio, outputs

    # ------------------------------------------------------------------
    def run(self, iq: np.ndarray | jnp.ndarray,
            params: ChannelParams | None = None,
            channels: tuple[int, ...] | None = None, jit: bool = True):
        """Scan the chain over a full capture.

        iq: (..., n_blocks*BLOCK) complex; leading dims are channels.
        Returns dict of streamed outputs (time axis last).
        """
        iq = np.asarray(iq)
        ch = iq.shape[:-1] if channels is None else channels
        n_blocks = iq.shape[-1] // C.BLOCK_SIZE
        blocks = iq[..., : n_blocks * C.BLOCK_SIZE]
        blocks = blocks.reshape(ch + (n_blocks, C.BLOCK_SIZE))
        blocks = np.moveaxis(blocks, -2, 0)   # (n_blocks, ..., BLOCK)
        if params is None:
            params = default_params(ch)

        def scan_all(blocks, params):
            def step(st, blk):
                st, out = self.block(params, st, blk)
                return st, out

            st = self.init_state(ch)
            return jax.lax.scan(step, st, blocks)

        if jit:
            _, outs = jax.jit(scan_all)(blocks, params)
        else:
            _, outs = scan_all(blocks, params)

        def flatten(leaf):
            # (n_blocks, ...ch, N) -> (...ch, n_blocks*N) sample streams;
            # (n_blocks, ...ch)    -> (...ch, n_blocks) per-block series
            if leaf.ndim == len(ch) + 2:
                return jnp.moveaxis(leaf, 0, -2).reshape(ch + (-1,))
            return jnp.moveaxis(leaf, 0, -1)

        return {k: flatten(v) for k, v in outs.items()}


def iq_correction(i_part: jnp.ndarray, q_part: jnp.ndarray,
                  amp: jnp.ndarray, phase: jnp.ndarray) -> jnp.ndarray:
    """Manual IQ amplitude + phase correction (Process.cpp:163-175,
    Utility.cpp:178-187): scale I, then mix factor*Q into I (positive
    factor) or factor*I into Q (negative factor).

    i_part/q_part: (..., N);  amp/phase: (...,).  Returns complex64.
    """
    amp = amp[..., None]
    ph = phase[..., None]
    i_c = i_part * amp
    pos = ph >= 0
    i_c = jnp.where(pos, i_c + ph * q_part, i_c)
    q_c = jnp.where(pos, q_part, q_part + ph * i_c)
    return (i_c + 1j * q_c).astype(jnp.complex64)


def volume_to_amplification(volume: jnp.ndarray) -> jnp.ndarray:
    """0..100 -> amplitude, x^5 taper (reference `VolumeToAmplification`,
    `Process.cpp:955-967`)."""
    x = volume / 100.0
    return 5.0 * x ** 5
