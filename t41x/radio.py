"""High-level radio API.

The user-facing surface of t41x: a `Radio` holds a `RadioConfig`
(persistable), builds the matching compiled RX/TX chains, and exposes the
reference's control operations (band/mode/tune/volume — the encoder and
button semantics of tmr4/T41_SDR `ButtonProc.cpp`/`Encoders.cpp`) as
methods, plus capture-level receive/decode entry points.

Control mutations are staged between processing calls (the functional
replacement for the reference's ISR-mutates-globals model, SURVEY §2.4):
changing band/mode swaps in a different compiled chain; changing dynamic
parameters just updates the `ChannelParams` arrays.
"""

from __future__ import annotations

import time

import numpy as np

from t41x import constants as C
from t41x.chain import ChainSpec, ChannelParams, RxChain, default_params
from t41x.config import RadioConfig
from t41x.kernels import agc_kernel_for


class Radio:
    def __init__(self, config: RadioConfig | None = None):
        self.config = config or RadioConfig()
        self._chain: RxChain | None = None
        self._chain_spec: ChainSpec | None = None
        self.metrics: dict = {}

    # --- control surface (reference: buttons/encoders/menus) ----------
    def set_band(self, index_or_name) -> None:
        cfg = self.config
        if isinstance(index_or_name, str):
            names = [b.name for b in cfg.bands]
            index_or_name = names.index(index_or_name.upper())
        cfg.current_band = int(index_or_name)
        cfg.center_freq = cfg.band.freq
        self._chain = None

    def set_mode(self, mode: str) -> None:
        self.config.band.mode = mode
        # SetupMode defaults (Filter.cpp:341-385)
        if mode in ("usb", "ft8", "psk31", "nfm", "cw"):
            self.config.band.f_lo_cut, self.config.band.f_hi_cut = 200, 3000
        elif mode == "lsb":
            self.config.band.f_lo_cut, self.config.band.f_hi_cut = -3000, -200
        elif mode in ("am", "sam"):
            self.config.band.f_lo_cut, self.config.band.f_hi_cut = -3000, 3000
        self._chain = None

    def set_filter(self, f_lo: float, f_hi: float) -> None:
        self.config.band.f_lo_cut = int(f_lo)
        self.config.band.f_hi_cut = int(f_hi)
        self._chain = None

    def set_fine_tune(self, hz: float) -> None:
        """NCO fine tune with band-edge recentering (reference
        `SetNCOFreq` `Tune.cpp:141-172`): when the tuned signal would
        leave the visible zoomed spectrum, fold the offset into the
        center frequency and reset the NCO."""
        cfg = self.config
        nco = float(hz)
        zoom = max(cfg.spectrum_zoom, 0)
        if zoom != 0:
            edge = 96_000 / (1 << zoom)
            if (nco + cfg.band.f_hi_cut) >= edge \
                    or (nco + cfg.band.f_lo_cut) <= -edge:
                cfg.center_freq = int(cfg.center_freq + nco)
                cfg.nco_freq = 0.0
                return
        elif nco > 142_000 or nco < -43_000:
            cfg.center_freq = int(cfg.center_freq + nco)
            cfg.nco_freq = 0.0
            return
        cfg.nco_freq = nco

    def toggle_vfo(self) -> None:
        """Swap VFO A/B (reference split-VFO handling, `Tune.cpp:251`)."""
        cfg = self.config
        cfg.center_freq, cfg.center_freq_b = (cfg.center_freq_b,
                                              cfg.center_freq)
        cfg.active_vfo = "B" if cfg.active_vfo == "A" else "A"

    def set_split(self, on: bool) -> None:
        self.config.split_on = bool(on)

    def set_volume(self, vol: int) -> None:
        self.config.audio_volume = int(np.clip(vol, 0, 100))

    def set_agc(self, mode: int) -> None:
        self.config.agc_mode = int(mode)
        self._chain = None

    def set_nr(self, mode: int) -> None:
        self.config.nr_mode = int(mode)
        self._chain = None

    def set_zoom(self, zoom: int) -> None:
        self.config.spectrum_zoom = int(zoom)
        self._chain = None

    def change_freq_increment(self, steps: int = 1) -> int:
        """Cycle the center-tune step table (reference
        `ChangeFreqIncrement` `ButtonProc.cpp:470`); returns the new
        increment in Hz."""
        from t41x.config import FREQ_INCREMENTS
        cfg = self.config
        cfg.tune_index = (cfg.tune_index + steps) % len(FREQ_INCREMENTS)
        return FREQ_INCREMENTS[cfg.tune_index]

    def change_ft_increment(self, steps: int = 1) -> int:
        """Cycle the fine-tune step table (reference `ChangeFtIncrement`
        `ButtonProc.cpp:494`); returns the new increment in Hz."""
        from t41x.config import FT_INCREMENTS
        cfg = self.config
        cfg.ft_index = (cfg.ft_index + steps) % len(FT_INCREMENTS)
        cfg.fine_tune_step = FT_INCREMENTS[cfg.ft_index]
        return cfg.fine_tune_step

    def set_noise_floor(self, value: int) -> None:
        """Per-band spectrum noise floor (reference CAT NF,
        `currentNoiseFloor[currentBand]`)."""
        self.config.band.noise_floor = int(value)

    def set_eq(self, which: str, on: bool) -> None:
        """Enable/disable the 14-band receive or transmit EQ (reference
        `MenuProc.cpp:318/:348` EQ set menus)."""
        if which == "rx":
            self.config.receive_eq_on = bool(on)
            self._chain = None   # static graph change
        elif which == "tx":
            self.config.xmit_eq_on = bool(on)
        else:
            raise ValueError("which must be 'rx' or 'tx'")

    def set_eq_band(self, which: str, band_idx: int, gain: int) -> None:
        """Set one EQ band gain, 0..100 (the reference edits
        `equalizerRec/Xmt[14]` live from the EQ menus).  Receive gains
        are dynamic params — they take effect next block without a
        chain swap."""
        if not 0 <= band_idx < 14:
            raise ValueError("EQ band index 0..13")
        gains = (self.config.equalizer_rec if which == "rx"
                 else self.config.equalizer_xmt if which == "tx"
                 else None)
        if gains is None:
            raise ValueError("which must be 'rx' or 'tx'")
        gains[band_idx] = int(np.clip(gain, 0, 100))

    def set_mic_gain(self, gain: int) -> None:
        """Mic gain, dB (reference `MenuProc.cpp:436` mic menu ->
        `currentMicGain`)."""
        self.config.mic_gain = int(np.clip(gain, -40, 30))

    def set_mic_compression(self, ratio: float) -> None:
        """Mic compression control (reference `currentMicCompRatio`;
        negative = compressor off, matching `SetupMyCompressors`
        `DSP_Fn.cpp:83-103`)."""
        self.config.mic_compression = float(ratio)

    def save_favorite(self, slot: int) -> int:
        """Store the current center frequency in a favorites slot
        (reference `EEPROMData.favoriteFreqs[13]`, set via the EEPROM
        menu)."""
        if not 0 <= slot < 13:
            raise ValueError("favorite slot 0..12")
        favs = self.config.favorites
        while len(favs) < 13:
            favs.append(0)
        favs[slot] = int(self.config.center_freq)
        return favs[slot]

    def recall_favorite(self, slot: int) -> int:
        """Tune to a stored favorite (reference `GetFavoriteFrequency`,
        band auto-switch included)."""
        favs = self.config.favorites
        if not 0 <= slot < len(favs) or not favs[slot]:
            raise ValueError(f"favorite slot {slot} is empty")
        freq = favs[slot]
        # auto-switch to the band containing the frequency
        for i, b in enumerate(self.config.bands):
            if b.band_low <= freq <= b.band_high:
                if i != self.config.current_band:
                    self.set_band(i)
                break
        self.config.center_freq = freq
        self.config.nco_freq = 0.0
        return freq

    def set_transmit_power(self, watts: float) -> None:
        self.config.transmit_power = float(np.clip(watts, 0.0, 20.0))

    def set_auto_rf_gain(self, on: bool) -> None:
        """Digitizer auto-gain (Codec_gain, Process.cpp:979-1027): the
        chain emits ADC clip taps and the runner steps band.rf_gain."""
        self.config.auto_rf_gain = bool(on)
        self._chain = None   # static graph change (clip_taps)

    # --- chain management ---------------------------------------------
    @property
    def chain(self) -> RxChain:
        if self._chain is None:
            import jax

            cfg = self.config
            spec = ChainSpec(
                mode=cfg.band.mode,
                f_lo=float(cfg.band.f_lo_cut),
                f_hi=float(cfg.band.f_hi_cut),
                agc_mode=cfg.agc_mode,
                agc_thresh_db=float(cfg.band.agc_thresh),
                nr_mode=cfg.nr_mode,
                notch_on=cfg.notch_on,
                eq_on=cfg.receive_eq_on,
                spectrum_zoom=cfg.spectrum_zoom,
                clip_taps=cfg.auto_rf_gain,
                cw_filter_index=cfg.cw_filter_index,
                cw_tone_hz=cfg.cw_sidetone_hz,
                interpolate_out=False,
                agc_kernel=agc_kernel_for(jax.default_backend()),
            )
            self._chain = RxChain(spec)
            self._chain_spec = spec
        return self._chain

    def params(self, channels: tuple[int, ...] = ()) -> ChannelParams:
        cfg = self.config
        p = default_params(channels, nco_freq=cfg.nco_freq,
                           volume=cfg.audio_volume)
        return p._replace(
            rf_gain_db=np.full(channels, cfg.rf_gain_all_bands, np.float32),
            band_gain=np.full(channels, float(cfg.band.rf_gain), np.float32),
            iq_amp=np.full(channels, cfg.band.iq_amp_correction, np.float32),
            iq_phase=np.full(channels, cfg.band.iq_phase_correction,
                             np.float32),
            eq_gains=np.asarray(cfg.equalizer_rec, np.float32)[None].repeat(
                max(int(np.prod(channels)), 1), 0).reshape(
                channels + (14,)) / 100.0,
        )

    # --- capture processing -------------------------------------------
    def receive(self, iq: np.ndarray) -> dict:
        """Run a capture through the configured chain.  iq: (..., N)
        complex64 at 192 kHz.  Returns the chain outputs plus metrics."""
        ch = iq.shape[:-1]
        t0 = time.perf_counter()
        out = self.chain.run(iq, params=self.params(ch))
        out = {k: np.asarray(v) for k, v in out.items()}
        dt = time.perf_counter() - t0
        n_samples = int(np.prod(iq.shape))
        self.metrics = {
            "wall_s": dt,
            "input_samples": n_samples,
            "samples_per_sec": n_samples / dt,
            "realtime_channels": n_samples / dt / C.SAMPLE_RATE,
            "mode": self.config.band.mode,
        }
        return out

    def receive_wav(self, path: str) -> dict:
        from t41x.io import wav

        iq, rate = wav.read_iq_wav(path)
        if rate != C.SAMPLE_RATE:
            raise ValueError(f"{path}: expected {C.SAMPLE_RATE} Hz I/Q, "
                             f"got {rate}")
        return self.receive(iq)

    # --- decoders ------------------------------------------------------
    def decode_ft8(self, iq: np.ndarray) -> list:
        self.set_mode("ft8")
        out = self.receive(iq)
        from t41x.decode.ft8 import decode as ft8

        return ft8.decode_audio(out["audio_24k"].astype(np.float32),
                                my_grid=self.config.my_grid)

    def decode_cw(self, iq: np.ndarray) -> str:
        self.set_mode("cw")
        out = self.receive(iq)
        from t41x.decode import cw_text

        return cw_text.decode_envelope(out["cw_keyed"].astype(bool))

    def decode_psk31(self, iq: np.ndarray, tone_hz: float = 1000.0) -> str:
        self.set_mode("psk31")
        out = self.receive(iq)
        from t41x.decode import psk31

        return psk31.decode_capture(out["iq_baseband"], tone_hz=tone_hz)

    # --- transmit ------------------------------------------------------
    def transmit_ssb(self, mic: np.ndarray) -> np.ndarray:
        """Mic audio (192 kHz float) -> SSB I/Q at 192 kHz (the QSE
        drive signal), using the band sideband and TX corrections."""
        import jax.numpy as jnp

        from t41x.chain import tx

        cfg = self.config
        spec = tx.TxSpec(sideband="lsb" if cfg.band.mode == "lsb" else "usb",
                         eq_on=cfg.xmit_eq_on,
                         compressor_on=cfg.mic_compression < 0)
        ex = tx.SSBExciter(spec)
        params = tx.default_tx_params()._replace(
            iq_amp=np.float32(cfg.band.iq_amp_correction_tx),
            iq_phase=np.float32(cfg.band.iq_phase_correction_tx),
            eq_gains=np.asarray(cfg.equalizer_xmt, np.float32) / 100.0)
        st = ex.init_state(())
        outs = []
        nb = len(mic) // C.BLOCK_SIZE
        for b in range(nb):
            st, iq = ex.block(params, st, jnp.asarray(
                mic[b * C.BLOCK_SIZE:(b + 1) * C.BLOCK_SIZE]))
            outs.append(np.asarray(iq))
        return np.concatenate(outs)

    def transmit_cw(self, text: str, wpm: float | None = None) -> np.ndarray:
        """Keyed CW I/Q at 192 kHz for a text message (keyer state
        machine -> shaped quadrature sidetone)."""
        import jax.numpy as jnp

        from t41x.chain import tx
        from t41x.io import signals

        cfg = self.config
        wpm = wpm or cfg.cw_wpm
        ex = tx.CWExciter(tone_hz=cfg.cw_sidetone_hz)
        env = signals.cw_keying_envelope(
            signals.text_to_morse_pattern(text), wpm,
            int((len(text) * 12.0 / wpm + 1.0) * C.SAMPLE_RATE))
        nb = len(env) // C.BLOCK_SIZE
        drive = float(tx.cw_power_scale(cfg.cw_power) / 20.0)
        st = ex.init_state(())
        outs = []
        for b in range(nb):
            key = env[b * C.BLOCK_SIZE:(b + 1) * C.BLOCK_SIZE].mean() > 0.5
            st, iq = ex.block(st, jnp.asarray(float(key)), drive)
            outs.append(np.asarray(iq))
        return np.concatenate(outs)

    def transmit_ft8(self, message: str,
                     base_freq: float = 1200.0) -> np.ndarray:
        """FT8 message -> 192 kHz I/Q (GFSK tones as a USB signal)."""
        from t41x.decode.ft8 import encode

        return encode.synth_iq(message, base_freq=base_freq,
                               nco=self.config.nco_freq)
