"""Live streaming runner — the `loop()` replacement.

Ties the native block runtime to the compiled chain and the output
servers: the functional re-expression of the reference's main loop
(tmr4/T41_SDR `T41_SDR.ino:1000-1338`), which interleaved DSP, display,
and control on one core.  Here:

  * an acquisition source (hardware frontend, network, or the paced
    capture streamer) pushes I/Q blocks into a lock-free ring
    (`t41x.io.runtime`),
  * the runner pops batches, runs the jitted chain block, meters load
    (the reference's CPU-load %), and
  * publishes spectrum/S-meter frames to the control server and feeds
    decoders (CW envelope, FT8 slots) incrementally.

Control changes (band/mode/tune via the `Radio` API or the CAT server)
take effect between blocks — staged, never racing the DSP.
"""

from __future__ import annotations

import numpy as np

from t41x import constants as C
from t41x.io.runtime import BlockRing, LoadMeter
from t41x.radio import Radio


class StreamRunner:
    """channels: a channel-batch shape (e.g. (256,)) — the ring then
    carries (channels..., BLOCK) I/Q per entry and one dispatch serves
    every channel.  batch_blocks: process B ring entries per device
    dispatch (one lax.scan): B blocks share one launch and one host
    round trip, and get B block budgets (10.67 ms each) for it."""

    def __init__(self, radio: Radio, ring: BlockRing | None = None,
                 control_server=None, cat_handler=None, slot_clock=None,
                 channels: tuple[int, ...] = (), batch_blocks: int = 1,
                 display_every: int = 4):
        self.channels = tuple(channels)
        self.batch_blocks = int(batch_blocks)
        # batched mode: publish display taps every Nth dispatch — the
        # reference's updateDisplayFlag refreshes the panadapter once
        # per screen pass, not per DSP block (Display.cpp:261-267)
        self.display_every = int(display_every)
        self._batch_count = 0
        n_floats = 2 * C.BLOCK_SIZE
        for d in self.channels:
            n_floats *= d
        self.radio = radio
        self.ring = ring or BlockRing(block_floats=n_floats)
        self.control = control_server
        self.cat = cat_handler
        self.slot_clock = slot_clock  # wall-clock fn for FT8 slot sync
        self.load = LoadMeter(force_python=self.batch_blocks > 1)
        self.blocks_processed = 0
        self._state = None
        self._spec_key = None
        self._block_fn = None
        self._cw_keyed: list[bool] = []
        self._morse = None
        self._ft8_slots = None
        self._codec_gain = None
        self.audio_chunks: list[np.ndarray] = []
        self.keep_audio = False
        self.last_rf_spectrum_db: np.ndarray | None = None
        self.last_audio_spectrum: np.ndarray | None = None
        self.last_smeter_dbm: float | None = None

    # ------------------------------------------------------------------
    def _ensure_chain(self):
        chain = self.radio.chain  # rebuilds on config change
        key = id(chain)
        if key != self._spec_key:
            import jax

            self._state = chain.init_state(self.channels)
            self._spec_key = key
            # one compiled graph per chain spec: the eager per-op path
            # misses real time by far
            self._block_fn = jax.jit(chain.block)

            # built unconditionally: step_batch() is a public method and
            # must work at batch_blocks == 1 too (a scan over one block;
            # compilation is lazy, so an unused batch_fn costs nothing)
            # block_batch == scanning block, but the NR stage runs
            # batched across the B blocks where the algorithm allows
            # (cross-block NR batching, chain/rx.py)
            self._batch_fn = jax.jit(chain.block_batch)
            if chain.spec.mode == "cw":
                from t41x.decode.cw_text import MorseDecoder

                self._morse = MorseDecoder(wpm_hint=self.radio.config.cw_wpm)
            if chain.spec.mode == "ft8":
                from t41x.decode.ft8.slots import SlotManager

                self._ft8_slots = SlotManager(
                    clock=self.slot_clock,
                    my_grid=self.radio.config.my_grid)
        return chain

    def prime(self) -> None:
        """Compile the current chain's block graph WITHOUT consuming ring
        data or advancing state — call before attaching a real-time
        source so the first live block doesn't pay the trace+compile
        stall (which would overflow the ring at rate_factor=1)."""
        import jax

        self._ensure_chain()
        params = self.radio.params(self.channels)
        if self.batch_blocks > 1:
            st, outs = self._batch_fn(
                params, self._state,
                np.zeros((self.batch_blocks,) + self.channels
                         + (C.BLOCK_SIZE,), np.complex64))
            jax.block_until_ready(outs["audio_24k"])
            return
        st, out = self._block_fn(
            params, self._state,
            np.zeros(self.channels + (C.BLOCK_SIZE,), np.complex64))
        jax.block_until_ready(out["audio_24k"])

    def step(self) -> dict | None:
        """Process one block from the ring (None if ring empty)."""
        block = self.ring.pop_iq()
        if block is None:
            return None
        block = block.reshape(self.channels + (C.BLOCK_SIZE,))
        self._ensure_chain()
        params = self.radio.params(self.channels)
        self.load.begin()
        self._state, out = self._block_fn(params, self._state, block)
        out["audio_24k"].block_until_ready()
        self.load.end()
        self.blocks_processed += 1

        results = {"load_percent": self.load.percent}
        if self.keep_audio:
            self.audio_chunks.append(np.asarray(out["audio_24k"]))
        # latest display taps, for the control server AND the live
        # operator session (t41x.io.repl); a channel batch publishes
        # its first channel, like step_batch
        ch0 = (0,) * len(self.channels)
        if "rf_spectrum" in out:
            self.last_rf_spectrum_db = 10 * np.log10(
                np.asarray(out["rf_spectrum"])[ch0] + 1e-12)
            if self.control is not None:
                self.control.publish_rf_spectrum(self.last_rf_spectrum_db)
        if "audio_spectrum" in out:
            self.last_audio_spectrum = np.asarray(
                out["audio_spectrum"])[ch0]
        if "smeter_avg" in out:
            from t41x.dsp.spectrum import smeter_dbm

            dbm = float(smeter_dbm(np.asarray(out["smeter_avg"])[ch0]))
            self.last_smeter_dbm = dbm
            if self.control is not None:
                self.control.publish_smeter(dbm)
            if self.cat is not None:
                self.cat.smeter_dbm = dbm
        if self._morse is not None and "cw_keyed" in out:
            text = self._morse.feed(
                [bool(np.asarray(out["cw_keyed"])[ch0])])
            if text:
                results["cw_text"] = text
        if self._ft8_slots is not None:
            decoded = self._ft8_slots.feed(
                np.asarray(out["audio_24k"])[ch0])
            if decoded:
                results["ft8"] = decoded
        if "adc_half_clip" in out:
            self._apply_codec_gain(
                np.asarray(out["adc_half_clip"])[None],
                np.asarray(out["adc_quarter_clip"])[None])
        return results

    def _apply_codec_gain(self, halfs, quarts) -> None:
        """Step the band RF gain from per-block ADC clip flags — the
        reference's Codec_gain loop (Process.cpp:939,979-1027), run on
        the operator channel."""
        if self._codec_gain is None:
            from t41x.chain.codec_gain import CodecGain

            self._codec_gain = CodecGain()
        ch0 = (slice(None),) + (0,) * len(self.channels)
        g = int(self.radio.config.band.rf_gain)
        for h, q in zip(halfs[ch0].reshape(-1), quarts[ch0].reshape(-1)):
            g = self._codec_gain.step(bool(h), bool(q), g)
        self.radio.config.band.rf_gain = g

    def step_batch(self) -> dict | None:
        """Process `batch_blocks` ring entries in ONE device dispatch
        (None if fewer are queued).  Display taps publish from the
        batch's last block; decoders are fed the whole audio stream."""
        import jax

        if self.ring.available() < self.batch_blocks:
            return None
        blocks = np.stack([
            self.ring.pop_iq().reshape(self.channels + (C.BLOCK_SIZE,))
            for _ in range(self.batch_blocks)])
        self._ensure_chain()
        params = self.radio.params(self.channels)
        self.load.begin()
        self._state, outs = self._batch_fn(params, self._state, blocks)
        jax.block_until_ready(outs["audio_24k"])
        self.load.end(self.batch_blocks)
        self.blocks_processed += self.batch_blocks
        self._batch_count += 1

        results = {"load_percent": self.load.percent}
        need_audio = (self.keep_audio or self._morse is not None
                      or self._ft8_slots is not None)
        if need_audio:
            audio = np.asarray(outs["audio_24k"])   # (B, ..., 256)
        if self.keep_audio:
            self.audio_chunks.append(
                np.moveaxis(audio, 0, -2).reshape(self.channels + (-1,)))
        ch0 = (0,) * len(self.channels)
        if self._batch_count % self.display_every == 0:
            out_last = {k: np.asarray(v)[-1] for k, v in outs.items()
                        if hasattr(v, "dtype") and v.ndim > 0}
            if "rf_spectrum" in out_last:
                self.last_rf_spectrum_db = 10 * np.log10(
                    np.asarray(out_last["rf_spectrum"])[ch0] + 1e-12)
                if self.control is not None:
                    self.control.publish_rf_spectrum(
                        self.last_rf_spectrum_db)
            if "audio_spectrum" in out_last:
                self.last_audio_spectrum = np.asarray(
                    out_last["audio_spectrum"])[ch0]
            if "smeter_avg" in out_last:
                from t41x.dsp.spectrum import smeter_dbm

                dbm = float(smeter_dbm(out_last["smeter_avg"][ch0]))
                self.last_smeter_dbm = dbm
                if self.control is not None:
                    self.control.publish_smeter(dbm)
                if self.cat is not None:
                    self.cat.smeter_dbm = dbm
        if self._morse is not None and "cw_keyed" in outs:
            keyed = np.asarray(outs["cw_keyed"])      # (B, ...)
            text = self._morse.feed([bool(k[ch0]) for k in keyed])
            if text:
                results["cw_text"] = text
        if self._ft8_slots is not None:
            decoded = self._ft8_slots.feed(
                audio[(slice(None),) + ch0].reshape(-1))
            if decoded:
                results["ft8"] = decoded
        if "adc_half_clip" in outs:
            self._apply_codec_gain(np.asarray(outs["adc_half_clip"]),
                                   np.asarray(outs["adc_quarter_clip"]))
        return results

    def drain(self, max_blocks: int | None = None) -> int:
        """Process everything currently available; returns block count."""
        n = 0
        while max_blocks is None or n < max_blocks:
            if self.batch_blocks > 1:
                if self.step_batch() is None:
                    break
                n += self.batch_blocks
            else:
                if self.step() is None:
                    break
                n += 1
        return n

    @property
    def audio(self) -> np.ndarray:
        if not self.audio_chunks:
            return np.zeros(0, np.float32)
        return np.concatenate(self.audio_chunks)
