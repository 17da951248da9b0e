"""The DFT helpers (`t41x.dsp.dft`) vs numpy (reference FFT call sites
use `arm_cfft_f32`/`arm_rfft_q15`).  `fft`/`ifft`/`rfft` are one path,
`jnp.fft`, on every backend; `rdft_half`/`irdft_half_real` are the NR
stages' dense real-DFT matmuls."""

import jax
import numpy as np
import pytest

from t41x.dsp import dft


@pytest.mark.parametrize("n", [32, 256, 512, 1024, 2048])
def test_fft_matmul_matches_numpy(n):
    rng = np.random.default_rng(n)
    x = (rng.standard_normal((5, n)) + 1j * rng.standard_normal((5, n))
         ).astype(np.complex64)
    ref = np.fft.fft(x, axis=-1)
    got = np.asarray(dft.fft(x))
    assert np.max(np.abs(got - ref)) / np.max(np.abs(ref)) < 1e-5


@pytest.mark.parametrize("n", [256, 512, 2048])
def test_ifft_matmul_roundtrip(n):
    rng = np.random.default_rng(n)
    x = (rng.standard_normal((3, n)) + 1j * rng.standard_normal((3, n))
         ).astype(np.complex64)
    back = np.asarray(dft.ifft(dft.fft(x)))
    assert np.max(np.abs(back - x)) < 1e-5
    ref = np.fft.ifft(x, axis=-1)
    got = np.asarray(dft.ifft(x))
    assert np.max(np.abs(got - ref)) < 1e-6


def test_rfft_padded_matches_numpy():
    rng = np.random.default_rng(7)
    r = rng.standard_normal((4, 1600)).astype(np.float32)
    ref = np.fft.rfft(r, n=2048, axis=-1)
    got = np.asarray(dft.rfft(r, n=2048))
    assert np.max(np.abs(got - ref)) < 1e-3  # abs scale ~1e3 bins


def test_dispatch_on_cpu_uses_exact_fft():
    # one path on every backend: the transform is XLA's FFT op, never a
    # matmul DFT picked by platform
    x = (np.arange(512) % 7).astype(np.complex64)[None]
    jaxpr = str(jax.make_jaxpr(dft.fft)(x))
    assert "fft" in jaxpr and "dot_general" not in jaxpr
    assert np.allclose(np.asarray(dft.fft(x)), np.fft.fft(x, axis=-1),
                       atol=1e-3)


def test_rdft_half_matches_numpy():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 256)).astype(np.float32)
    xr, xi = dft.rdft_half(x)
    ref = np.fft.rfft(x.astype(np.float64), axis=-1)
    np.testing.assert_allclose(np.asarray(xr), ref.real, atol=2e-4)
    np.testing.assert_allclose(np.asarray(xi), ref.imag, atol=2e-4)
    back = dft.irdft_half_real(xr, xi)
    np.testing.assert_allclose(np.asarray(back), x, atol=2e-5)
