"""Full-chain golden parity: the jitted chain vs an independent
NumPy oracle built from the same filter designs (SURVEY.md §4 test
strategy item 2 — with no runnable reference firmware, the oracle chain
plays the role of the recorded golden output; every stage is composed
from first-principles NumPy ops, not the JAX kernels)."""

import numpy as np

from t41x import constants as C
from t41x.chain import ChainSpec, RxChain
from t41x.io import signals


def oracle_chain(iq: np.ndarray, chain: RxChain,
                 nco_freq: float = 0.0) -> np.ndarray:
    """NumPy reference: Fs/4 shift -> NCO -> x4 -> x2 decimation ->
    overlap-save band-pass (as direct convolution) -> real part."""
    x = iq.astype(np.complex128)
    n = len(x)
    # Fs/4 shift
    x = x * (1j ** (np.arange(n) % 4))
    # NCO mix down (phase convention of t41x.dsp.nco: theta_n uses n+1)
    w = 2 * np.pi * nco_freq / C.SAMPLE_RATE
    x = 1.1 * x * np.exp(-1j * w * np.arange(1, n + 1))

    def decim(sig, h, m):
        full = np.convolve(sig, h.astype(np.float64) if h.ndim else h)
        # causal filter then keep phase m-1 (CMSIS convention)
        causal = full[: len(sig)]
        return causal[m - 1:: m]

    def decim_c(sig, h, m):
        return (decim(sig.real, h, m) + 1j * decim(sig.imag, h, m))

    x = decim_c(x, chain.h1.astype(np.float64), C.DF1)
    x = decim_c(x, chain.h2.astype(np.float64), C.DF2)
    x = x * chain.vol_scale
    # overlap-save == plain linear convolution with the complex taps
    taps = np.fft.ifft(chain.mask.astype(np.complex128))[:257]
    y = np.convolve(x, taps)[: len(x)]
    return y.real


def test_full_chain_matches_numpy_oracle():
    n = 24 * C.BLOCK_SIZE
    rng = np.random.default_rng(12)
    # band-limited random I/Q around the USB audio band
    iq = (signals.usb_signal([400.0, 900.0, 1700.0, 2600.0], n,
                             amps=[1.0, 0.7, 0.5, 0.3]) * 0.2
          + signals.awgn(n, 0.01, seed=3))
    chain = RxChain(ChainSpec(mode="usb", agc_mode=0, spectrum_taps=False,
                              interpolate_out=False))
    got = np.asarray(chain.run(np.asarray(iq))["audio_24k"],
                     dtype=np.float64)
    # AGC off applies fixed_gain 20
    want = oracle_chain(np.asarray(iq), chain) * 20.0
    m = min(len(got), len(want))
    err = got[256:m] - want[256:m]
    snr = 10 * np.log10(np.mean(want[256:m] ** 2)
                        / (np.mean(err ** 2) + 1e-30))
    assert snr > 55.0, snr


def test_full_chain_oracle_with_nco():
    n = 16 * C.BLOCK_SIZE
    iq = signals.usb_signal([1200.0], n, nco=4000.0) * 0.3
    chain = RxChain(ChainSpec(mode="usb", agc_mode=0, spectrum_taps=False,
                              interpolate_out=False))
    from t41x.chain import default_params

    params = default_params((), nco_freq=4000.0)
    got = np.asarray(chain.run(np.asarray(iq), params=params)["audio_24k"],
                     dtype=np.float64)
    want = oracle_chain(np.asarray(iq), chain, nco_freq=4000.0) * 20.0
    m = min(len(got), len(want))
    err = got[256:m] - want[256:m]
    snr = 10 * np.log10(np.mean(want[256:m] ** 2)
                        / (np.mean(err ** 2) + 1e-30))
    assert snr > 50.0, snr
