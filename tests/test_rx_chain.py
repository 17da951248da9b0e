"""End-to-end RX chain tests — the golden slice (BASELINE config 1):
synthetic 192 kHz I/Q captures through the full decimate -> overlap-save
band-pass -> demod -> AGC chain, asserting demodulated audio quality."""

import jax.numpy as jnp
import numpy as np

from t41x import constants as C
from t41x.chain import ChainSpec, RxChain, default_params
from t41x.io import signals

SETTLE = 4096  # audio samples to skip (AGC/filter transients)
N_BLOCKS = 40  # 40 blocks = 10240 audio samples @ 24 kHz (~0.43 s)
N = N_BLOCKS * C.BLOCK_SIZE


def audio_of(chain, iq, **kw):
    out = chain.run(np.asarray(iq), **kw)
    return np.asarray(out["audio_24k"])


def test_usb_two_tone_golden():
    iq = signals.usb_signal([700.0, 1900.0], N, amps=[1.0, 0.5]) * 0.25
    iq += signals.awgn(N, 1e-4, seed=9)
    chain = RxChain(ChainSpec(mode="usb"))
    audio = audio_of(chain, iq)[SETTLE:]
    snr = signals.tone_fit_snr(audio, [700.0, 1900.0], C.AUDIO_RATE)
    assert snr > 30.0, snr


def test_lsb_two_tone_golden():
    iq = signals.lsb_signal([600.0, 2200.0], N) * 0.25
    chain = RxChain(ChainSpec(mode="lsb", f_lo=-3000.0, f_hi=-200.0))
    audio = audio_of(chain, iq)[SETTLE:]
    snr = signals.tone_fit_snr(audio, [600.0, 2200.0], C.AUDIO_RATE)
    assert snr > 30.0, snr


def test_usb_rejects_opposite_sideband():
    # tone on the LSB side must not appear in USB audio
    iq = signals.lsb_signal([1000.0], N) * 0.25
    chain = RxChain(ChainSpec(mode="usb"))
    audio = audio_of(chain, iq)[SETTLE:]
    iq2 = signals.usb_signal([1000.0], N) * 0.25
    audio2 = audio_of(chain, iq2)[SETTLE:]
    rej = 10 * np.log10(np.mean(audio2**2) / (np.mean(audio**2) + 1e-30))
    assert rej > 40.0, rej


def test_am_golden():
    iq = signals.am_signal(600.0, N, depth=0.6)
    chain = RxChain(ChainSpec(mode="am", f_lo=-3000.0, f_hi=3000.0))
    audio = audio_of(chain, iq)[SETTLE:]
    snr = signals.tone_fit_snr(audio - audio.mean(), [600.0], C.AUDIO_RATE)
    assert snr > 25.0, snr


def test_sam_golden_with_carrier_offset():
    iq = signals.am_signal(500.0, N, depth=0.6, nco=60.0)  # 60 Hz off-tune
    chain = RxChain(ChainSpec(mode="sam", f_lo=-3000.0, f_hi=3000.0))
    out = chain.run(np.asarray(iq))
    audio = np.array(out["audio_24k"])[SETTLE:]
    # AC-couple: the WDSP fade-leveler's 1.4 s carrier tracker leaves a
    # slow settling drift (sub-5 Hz), which a real audio path blocks
    audio = audio - np.convolve(audio, np.ones(801) / 801, "same")
    snr = signals.tone_fit_snr(audio[800:-800], [500.0], C.AUDIO_RATE)
    assert snr > 25.0, snr
    # PLL should report the carrier offset
    carrier = np.asarray(out["sam_carrier_hz"])[-1]
    assert abs(abs(carrier) - 60.0) < 20.0, carrier


def test_nfm_golden():
    iq = signals.nfm_signal(800.0, N, deviation=3000.0)
    chain = RxChain(ChainSpec(mode="nfm"))
    audio = audio_of(chain, iq)[SETTLE:]
    snr = signals.tone_fit_snr(audio - audio.mean(), [800.0], C.AUDIO_RATE)
    assert snr > 15.0, snr


def test_nco_fine_tuning():
    # signal 5 kHz above the Fs/4 point; NCO brings it to baseband
    iq = signals.usb_signal([1000.0], N, nco=5000.0) * 0.25
    chain = RxChain(ChainSpec(mode="usb"))
    params = default_params(nco_freq=5000.0)
    audio = np.asarray(chain.run(np.asarray(iq), params=params)["audio_24k"])
    snr = signals.tone_fit_snr(audio[SETTLE:], [1000.0], C.AUDIO_RATE)
    assert snr > 30.0, snr


def test_channel_batch_matches_single():
    iq0 = signals.usb_signal([700.0], N) * 0.25
    iq1 = signals.usb_signal([1500.0], N) * 0.25
    chain = RxChain(ChainSpec(mode="usb"))
    batch = np.stack([iq0, iq1])
    out_b = audio_of(chain, batch)
    out_0 = audio_of(chain, iq0)
    np.testing.assert_allclose(out_b[0], out_0, rtol=1e-3, atol=1e-4)
    snr1 = signals.tone_fit_snr(out_b[1][SETTLE:], [1500.0], C.AUDIO_RATE)
    assert snr1 > 30.0


def test_interpolated_output_192k():
    iq = signals.usb_signal([1000.0], N) * 0.25
    chain = RxChain(ChainSpec(mode="usb", interpolate_out=True))
    out = chain.run(np.asarray(iq))
    audio = np.asarray(out["audio"])
    assert audio.shape[-1] == N
    a = audio[8 * SETTLE:]
    snr = signals.tone_fit_snr(a, [1000.0], C.SAMPLE_RATE)
    assert snr > 25.0, snr


def test_smeter_and_spectrum_taps():
    iq = signals.usb_signal([1000.0], N) * 0.25
    chain = RxChain(ChainSpec(mode="usb", spectrum_taps=True))
    out = chain.run(np.asarray(iq))
    assert out["audio_spectrum"].shape[-1] == N_BLOCKS * C.FFT_LENGTH
    sm = np.asarray(out["smeter_avg"])
    assert sm.shape == (N_BLOCKS,)
    assert sm[-1] > 0


def test_matmul_osfilter_path_matches_fft_path():
    iq = signals.usb_signal([900.0, 2100.0], N) * 0.25
    a1 = audio_of(RxChain(ChainSpec(mode="usb", spectrum_taps=True)), iq)
    a2 = audio_of(RxChain(ChainSpec(mode="usb", spectrum_taps=False,
                                    use_matmul_osfilter=True)), iq)
    np.testing.assert_allclose(a1, a2, rtol=5e-2, atol=5e-4)


def test_chain_with_nr_eq_notch_zoom():
    iq = signals.usb_signal([800.0], N) * 0.25
    iq += signals.awgn(N, 0.01, seed=11)
    chain = RxChain(ChainSpec(mode="usb", nr_mode=2, eq_on=True,
                              notch_on=False, spectrum_zoom=1,
                              interpolate_out=False))
    out = chain.run(np.asarray(iq))
    audio = np.asarray(out["audio_24k"])[SETTLE:]
    snr = signals.tone_fit_snr(audio, [800.0], C.AUDIO_RATE)
    # steady tones are partially absorbed by the spectral-NR noise
    # tracker (see test_nr_eq_spectrum) — this test checks plumbing
    assert snr > 5.0, snr
    assert out["rf_spectrum"].shape[-1] == N_BLOCKS * 512


def test_chain_zoom1_spectrum_peak():
    # tone at (nco - fs/4 + 1000) = -47 kHz in the capture; zoom1 shows
    # the un-shifted spectrum, so expect a peak near -47 kHz
    iq = signals.usb_signal([1000.0], N) * 0.5
    chain = RxChain(ChainSpec(mode="usb", spectrum_zoom=0,
                              interpolate_out=False))
    out = chain.run(np.asarray(iq))
    spec = np.asarray(out["rf_spectrum"])[-512:]
    peak_bin = int(np.argmax(spec))
    f_per_bin = C.SAMPLE_RATE / 512
    peak_freq = (peak_bin - 256) * f_per_bin
    assert abs(peak_freq - (-47000.0)) < 2 * f_per_bin, peak_freq


def test_chain_kim_and_lms_nr_modes_run():
    # keyed tone: minimum-statistics NR nulls steady tones by design
    t = np.arange(N) / C.SAMPLE_RATE
    env = (np.sin(2 * np.pi * 8.0 * t) > 0).astype(np.float32)
    iq = signals.usb_signal([900.0], N) * 0.25 * env
    for nrm in (1, 3):
        chain = RxChain(ChainSpec(mode="usb", nr_mode=nrm,
                                  interpolate_out=False))
        audio = audio_of(chain, iq)[SETTLE:]
        assert np.isfinite(audio).all()
        # keyed tone: continuous-sine SNR is meaningless; require the
        # spectral peak at the tone frequency
        sp = np.abs(np.fft.rfft(audio))
        f = np.fft.rfftfreq(len(audio), 1 / C.AUDIO_RATE)
        assert abs(f[np.argmax(sp)] - 900.0) < 5.0, (nrm, f[np.argmax(sp)])


def test_block_batch_matches_scanned_block():
    """block_batch (cross-block NR batching, VERDICT r4 item 5) must be
    equivalent to scanning block() — outputs AND carried state — for
    the per-block Kim path, the AGC-kernel path (interpreted), and the
    batched spectral NR and display taps."""
    import jax

    rng = np.random.default_rng(4)
    ch, B = 3, 5
    t = np.arange(B * C.BLOCK_SIZE) / C.SAMPLE_RATE
    tone = 0.3 * np.exp(2j * np.pi * (C.SAMPLE_RATE / 4 + 1200.0) * t)
    iq = (tone + (rng.standard_normal((ch, t.size))
                  + 1j * rng.standard_normal((ch, t.size))) * 0.05
          ).astype(np.complex64)
    blocks = jnp.asarray(np.stack(np.split(iq, B, axis=-1)))

    for kw in (dict(mode="usb", nr_mode=1),
               dict(mode="usb", nr_mode=1, agc_kernel="interpret"),
               dict(mode="usb", nr_mode=2),
               dict(mode="usb", spectrum_zoom=0)):
        chain = RxChain(ChainSpec(**kw))
        params = jax.tree.map(np.asarray, default_params((ch,)))
        st = chain.init_state((ch,))
        s1, outs = st, []
        step = jax.jit(chain.block)
        for b in range(B):
            s1, o = step(params, s1, blocks[b])
            outs.append(o)
        s2, ob = jax.jit(chain.block_batch)(params, st, blocks)
        for k in outs[0]:
            ref = np.stack([np.asarray(o[k]) for o in outs])
            got = np.asarray(ob[k])
            np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-5,
                                       err_msg=f"{kw} {k}")
        for a, b in zip(jax.tree.leaves(s1), jax.tree.leaves(s2)):
            a = np.asarray(a).astype(np.complex128)
            b = np.asarray(b).astype(np.complex128)
            # atol scales with the leaf (power-spectrum EMA states sit
            # at ~10; filter states at ~1e-2) — fp32 fusion-order noise
            scale = float(np.max(np.abs(b))) if b.size else 0.0
            assert float(np.max(np.abs(a - b))) < max(1e-5,
                                                      1e-4 * scale), kw
