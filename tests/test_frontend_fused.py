"""Full-chain parity: the chain with the AGC kernel vs the plain chain.

The production chain on the GPU runs the AGC recurrence as the Triton
kernel (`ChainSpec(agc_kernel="triton")`); here the same kernel runs in
the Pallas interpreter (`agc_kernel="interpret"`), so these tests
exercise the production graph structure on the CPU.  Covered:
multi-block state carry, channel counts that are not multiples of the
kernel's channel tile, non-trivial per-channel params (NCO/gain/IQ
correction), spectrum-tap and no-tap OS-filter paths, the AM/SAM tails,
the zoom display taps, and state interchangeability between the kernel
and scan chains.
"""

import dataclasses

import jax
import numpy as np

from t41x import constants as C
from t41x.chain import ChainSpec, RxChain, default_params

RNG = np.random.default_rng(11)


def _params(ch):
    p = default_params((ch,))
    return p._replace(
        nco_freq=np.linspace(-500.0, 700.0, ch).astype(np.float32),
        rf_gain_db=np.linspace(-3.0, 6.0, ch).astype(np.float32),
        iq_amp=np.linspace(0.97, 1.03, ch).astype(np.float32),
        iq_phase=np.linspace(-0.02, 0.02, ch).astype(np.float32),
    )


def _iq(ch, blocks, seed=11):
    rng = np.random.default_rng(seed)
    t = np.arange(blocks * C.BLOCK_SIZE) / C.SAMPLE_RATE
    tone = 0.3 * np.exp(2j * np.pi * (C.SAMPLE_RATE / 4 + 1500.0) * t)
    noise = (rng.standard_normal((ch, t.size))
             + 1j * rng.standard_normal((ch, t.size))) * 0.05
    return (tone + noise).astype(np.complex64)


def _stream(spec, ch, blocks, params=None, iq=None):
    chain = RxChain(spec)
    params = _params(ch) if params is None else params
    iq = _iq(ch, blocks) if iq is None else iq
    step = jax.jit(chain.block)
    st = chain.init_state((ch,))
    outs = []
    for b in range(blocks):
        st, out = step(params, st,
                       iq[:, b * C.BLOCK_SIZE:(b + 1) * C.BLOCK_SIZE])
    outs.append(out)
    return chain, st, outs[-1]


def _assert_state_close(sa, sb, rtol=2e-3, atol=5e-4):
    # atol=5e-4: the DC-block biquad state is a near-unity-pole random
    # walk of fp32 rounding noise (the audio output stays at ~1e-6; see
    # the error-growth experiment in the r3 commit message)
    fa = jax.tree.leaves(sa)
    fb = jax.tree.leaves(sb)
    assert len(fa) == len(fb)
    for a, b in zip(fa, fb):
        b = np.asarray(b)
        # atol scales with the leaf's own magnitude so power-spectrum
        # EMA states (values in the tens) get the same relative bound
        # as unit-scale filter states
        scale = float(np.max(np.abs(b))) if b.size else 0.0
        np.testing.assert_allclose(np.asarray(a), b, rtol=rtol,
                                   atol=max(atol, 1e-3 * scale))


def _compare(spec_kw, ch, blocks=3, out_keys=("audio", "audio_24k")):
    plain = ChainSpec(agc_kernel=None, **spec_kw)
    fused = ChainSpec(agc_kernel="interpret", **spec_kw)
    _, st_p, out_p = _stream(plain, ch, blocks)
    chain_f, st_f, out_f = _stream(fused, ch, blocks)
    assert chain_f.spec.agc_kernel == "interpret"
    for k in out_keys:
        ref = np.asarray(out_p[k])
        if k == "rf_spectrum":
            # power-spectrum bins span many orders of magnitude; a 1e-7
            # fp32 input difference is relatively large on near-empty
            # bins, so compare against the spectrum's own scale
            np.testing.assert_allclose(
                np.asarray(out_f[k]), ref, rtol=2e-4,
                atol=2e-3 * float(np.max(np.abs(ref))), err_msg=k)
        else:
            np.testing.assert_allclose(
                np.asarray(out_f[k]), ref,
                rtol=2e-4, atol=2e-5, err_msg=k)
    _assert_state_close(st_f, st_p)


def test_fused_usb_full_chain_multiblock_state_carry():
    # production spec: spectrum taps + interpolation + AGC, 3 blocks so
    # every carried state (DC biquad, NCO phase, decim/OS/AGC/interp
    # histories) crosses block boundaries at least twice
    _compare(dict(mode="usb", spectrum_taps=True, interpolate_out=True),
             ch=8, blocks=3,
             out_keys=("audio", "audio_24k", "audio_spectrum",
                       "smeter_avg"))


def test_fused_non_tile_multiple_channels():
    # 5 and 130 channels: not multiples of the kernel's channel tile,
    # exercising the pad/trim plumbing in agc_triton.agc_gain
    _compare(dict(mode="usb"), ch=5, blocks=2)
    _compare(dict(mode="usb"), ch=130, blocks=2)


def test_fused_no_spectrum_taps_os_kernel_path():
    # spectrum_taps=False routes the OS filter through the single
    # operator matmul instead of the split-form taps
    _compare(dict(mode="usb", spectrum_taps=False, interpolate_out=False),
             ch=4, blocks=3)


def test_fused_am_tail():
    _compare(dict(mode="am"), ch=6, blocks=2)


def test_fused_sam_tail_post_lock():
    # The SAM PLL is chaotic during the lock transient — a 1e-7 input
    # perturbation alone produces ~4e-3 audio differences — so strict
    # kernel-vs-scan parity is only meaningful after lock.  Put the
    # carrier where the PLL can capture it (NCO centered), stream 6
    # blocks, and require both paths to converge to the same carrier
    # estimate and near-identical post-lock audio.
    ch, blocks = 4, 6
    params = default_params((ch,))
    # AM carrier that lands at ~30 Hz baseband after the +Fs/4 shift
    # (chain convention: fs4_shift moves -Fs/4 content to 0), 30% mod
    rng = np.random.default_rng(3)
    t = np.arange(blocks * C.BLOCK_SIZE) / C.SAMPLE_RATE
    env = 1.0 + 0.3 * np.cos(2 * np.pi * 400.0 * t)
    carrier = 0.4 * env * np.exp(2j * np.pi * (-C.SAMPLE_RATE / 4 + 30.0) * t)
    iq = (carrier + (rng.standard_normal((ch, t.size))
                     + 1j * rng.standard_normal((ch, t.size))) * 0.01
          ).astype(np.complex64)
    kw = dict(mode="sam", f_lo=-3000.0, f_hi=3000.0)
    _, st_p, out_p = _stream(ChainSpec(**kw), ch, blocks, params, iq)
    _, st_f, out_f = _stream(ChainSpec(agc_kernel="interpret", **kw),
                             ch, blocks, params, iq)
    # both locked to the true 30 Hz carrier offset
    np.testing.assert_allclose(np.asarray(out_p["sam_carrier_hz"]),
                               30.0, atol=2.0)
    np.testing.assert_allclose(np.asarray(out_f["sam_carrier_hz"]),
                               np.asarray(out_p["sam_carrier_hz"]),
                               atol=0.2)
    a_p = np.asarray(out_p["audio_24k"])
    a_f = np.asarray(out_f["audio_24k"])
    # 3% of full scale: the locked PLL amplifies any fp32 rounding
    # difference upstream of it near zero crossings
    np.testing.assert_allclose(a_f, a_p, rtol=0.02,
                               atol=0.03 * np.max(np.abs(a_p)))


def test_fused_zoom1_tap_in_kernel():
    # zoom x1 (the flagship's panadapter, CalcZoom1Magn) beside the
    # kernel AGC: display spectrum and audio match the scan chain
    spec_kw = dict(mode="usb", spectrum_zoom=0)
    chain = RxChain(ChainSpec(agc_kernel="interpret", **spec_kw))
    assert chain.zoomfft is None
    _compare(spec_kw, ch=4, blocks=3,
             out_keys=("audio", "audio_24k", "rf_spectrum"))


def test_fused_zoom_iir_tap_in_kernel():
    # zoom 2^z (elliptic IIR + strided decimator) beside the kernel AGC:
    # the displayed spectrum and audio match the scan chain
    for zoom in (1, 3, 7):
        spec_kw = dict(mode="usb", spectrum_zoom=zoom)
        chain = RxChain(ChainSpec(agc_kernel="interpret", **spec_kw))
        assert chain.zoomfft.zoom == zoom
        _compare(spec_kw, ch=4, blocks=3,
                 out_keys=("audio", "audio_24k", "rf_spectrum"))


def test_fused_zoom_state_interchange_with_plain():
    # run 2 blocks with the kernel AGC, hand the full state (incl.
    # ZoomState) to the scan chain for 2 more, and vice versa
    ch, blocks = 3, 4
    spec_p = ChainSpec(mode="usb", spectrum_zoom=2)
    spec_f = ChainSpec(mode="usb", spectrum_zoom=2, agc_kernel="interpret")
    chain_p, chain_f = RxChain(spec_p), RxChain(spec_f)
    params = _params(ch)
    iq = _iq(ch, blocks)
    blks = iq.reshape(ch, blocks, C.BLOCK_SIZE)

    import jax.numpy as jnp
    st_a = chain_f.init_state((ch,))
    st_b = chain_p.init_state((ch,))
    outs_a, outs_b = [], []
    for b in range(blocks):
        ca = chain_f if b < 2 else chain_p   # kernel -> scan
        cb = chain_p if b < 2 else chain_f   # scan -> kernel
        st_a, oa = ca.block(params, st_a, jnp.asarray(blks[:, b]))
        st_b, ob = cb.block(params, st_b, jnp.asarray(blks[:, b]))
        outs_a.append(oa["rf_spectrum"])
        outs_b.append(ob["rf_spectrum"])
    ref = np.asarray(outs_b[-1])
    np.testing.assert_allclose(np.asarray(outs_a[-1]), ref, rtol=2e-4,
                               atol=2e-3 * float(np.max(np.abs(ref))))


def test_fused_state_interchangeable_with_plain():
    # mid-stream handoff: alternate the kernel and scan chains block by
    # block — the carried pytrees are the same layout and semantics, so
    # outputs must keep matching
    ch, blocks = 4, 4
    kw = dict(mode="usb")
    plain = RxChain(ChainSpec(agc_kernel=None, **kw))
    fused = RxChain(ChainSpec(agc_kernel="interpret", **kw))
    params = _params(ch)
    iq = _iq(ch, blocks)
    sp = jax.jit(plain.block)
    sf = jax.jit(fused.block)

    st_ref = plain.init_state((ch,))
    st_mix = plain.init_state((ch,))
    for b in range(blocks):
        blk = iq[:, b * C.BLOCK_SIZE:(b + 1) * C.BLOCK_SIZE]
        st_ref, out_ref = sp(params, st_ref, blk)
        step = sf if b % 2 == 0 else sp  # alternate kernel/scan
        st_mix, out_mix = step(params, st_mix, blk)
        np.testing.assert_allclose(np.asarray(out_mix["audio_24k"]),
                                   np.asarray(out_ref["audio_24k"]),
                                   rtol=2e-4, atol=2e-5)
    _assert_state_close(st_mix, st_ref)


def test_fused_default_spec_is_production_spec():
    # the production chain on the card takes the compiled AGC kernel,
    # and bench.py's defaults time it with every display tap on
    import bench
    from t41x.kernels import agc_kernel_for

    spec = ChainSpec(agc_kernel=agc_kernel_for("gpu"), spectrum_taps=True,
                     interpolate_out=True)
    assert dataclasses.asdict(spec)["agc_kernel"] == "triton"
    assert set(bench._PEAKS["NVIDIA H100 80GB HBM3"]) == {
        "bf16", "tf32", "fp32", "hbm_bytes"}


def test_q15_ingest_fused_matches_unfused_q15():
    # ADC q15 int16 ingest (Process.cpp:102-111 arm_q15_to_float):
    # the chain converts at ingest; with the scan AGC it must match the
    # f32 path fed the same quantized values exactly, and with the
    # kernel AGC to fp32 rounding.
    ch, blocks = 6, 3
    iq = _iq(ch, blocks)
    i16 = np.clip(np.round(iq.real * 32768.0), -32768, 32767).astype(np.int16)
    q16 = np.clip(np.round(iq.imag * 32768.0), -32768, 32767).astype(np.int16)
    iq_q = ((i16.astype(np.float32) + 1j * q16.astype(np.float32))
            / 32768.0).astype(np.complex64)
    params = _params(ch)

    def stream(spec, data, pair):
        chain = RxChain(spec)
        step = jax.jit(chain.block)
        st = chain.init_state((ch,))
        for b in range(blocks):
            sl = slice(b * C.BLOCK_SIZE, (b + 1) * C.BLOCK_SIZE)
            blk = ((data[0][:, sl], data[1][:, sl]) if pair
                   else data[:, sl])
            st, out = step(params, st, blk)
        return st, out

    st_f32, out_f32 = stream(ChainSpec(mode="usb"), iq_q, False)
    st_qp, out_qp = stream(ChainSpec(mode="usb", q15_input=True),
                           (i16, q16), True)
    st_qf, out_qf = stream(
        ChainSpec(mode="usb", q15_input=True, agc_kernel="interpret"),
        (i16, q16), True)
    for k in ("audio", "audio_24k"):
        np.testing.assert_allclose(np.asarray(out_qp[k]),
                                   np.asarray(out_f32[k]),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
        np.testing.assert_allclose(np.asarray(out_qf[k]),
                                   np.asarray(out_f32[k]),
                                   rtol=2e-4, atol=2e-5, err_msg=k)
    _assert_state_close(st_qp, st_f32, rtol=1e-6, atol=1e-7)
    _assert_state_close(st_qf, st_f32)
