"""The SAM PLL and LMS (Xanr) scan paths against scalar float64
transcriptions of the reference loops (`Demod.cpp:40-139`,
`Noise.cpp:319-375`), streamed over several blocks with carried state.
These recurrences have no hand kernel; the scans are what runs."""

import jax
import jax.numpy as jnp
import numpy as np

from t41x import constants as C
from t41x.demod import sam as S
from t41x.dsp import nr as NR


def sam_oracle(p, y):
    """Per-sample WDSP SAM PLL with an exact atan2, float64."""
    phz = fil = om2 = dc = dci = 0.0
    audio = np.empty(len(y))
    for n, z in enumerate(y.astype(np.complex128)):
        s, c = np.sin(phz), np.cos(phz)
        ai, bi, aq, bq = c * z.real, s * z.real, c * z.imag, s * z.imag
        corr_re, corr_im = ai + bq, -bi + aq
        a = (ai - bi) + (aq + bq)
        if p.fade_leveler:
            dc = p.mtauR * dc + p.onem_mtauR * a
            dci = p.mtauI * dci + p.onem_mtauI * corr_re
            a = a + dci - dc
        det = np.arctan2(corr_im, corr_re)
        del_out = fil
        om2 = min(max(om2 + p.g2 * det, p.omega_min), p.omega_max)
        fil = p.g1 * det + om2
        phz = np.mod(phz + del_out, 2.0 * np.pi)
        audio[n] = a
    return audio, om2


def test_sam_scan_matches_oracle():
    ch, n, blocks = 3, 256, 12
    p = S.sam_params()
    t = np.arange(blocks * n) / C.AUDIO_RATE
    offsets = np.array([-40.0, 25.0, 90.0])[:, None]
    y = ((1.0 + 0.4 * np.cos(2 * np.pi * 400.0 * t))
         * np.exp(2j * np.pi * offsets * t) * 0.5).astype(np.complex64)
    st = jax.tree.map(jnp.asarray, S.sam_state((ch,)))
    audio = []
    for b in range(blocks):
        st, a, carrier = S.sam_demod(p, st, jnp.asarray(y[:, b * n:(b + 1) * n]))
        audio.append(np.asarray(a))
    audio = np.concatenate(audio, axis=-1)
    for c in range(ch):
        ref, om2 = sam_oracle(p, y[c])
        np.testing.assert_allclose(
            float(carrier[c]), om2 * C.AUDIO_RATE / (2 * np.pi), atol=0.05)
        # after lock (last half second): float32 scan vs float64 oracle
        np.testing.assert_allclose(audio[c, -12000:], ref[-12000:],
                                   atol=2e-3 * np.max(np.abs(ref)))


def xanr_oracle(p, st, x):
    """Per-sample variable-leak LMS over a newest-first delay line,
    float64.  st: one channel's XanrState; returns (y, w, lidx)."""
    T, D = p.taps, p.delay
    hist = np.asarray(st.dline, np.float64).copy()   # hist[m] = x[n-1-m]
    w = np.asarray(st.w, np.float64).copy()           # w[k] <-> x[n-D-k]
    lidx, ngamma = float(st.lidx), float(st.ngamma)
    out = np.empty(len(x))
    for n, xn in enumerate(np.asarray(x, np.float64)):
        reg = hist[D - 1: D - 1 + T]
        y = np.dot(w, reg)
        sigma = np.dot(reg, reg)
        inv_sigp = 1.0 / (sigma + 1e-10)
        err = xn - y
        out[n] = err if p.notch else y
        nel = abs(err * (1.0 - p.two_mu * sigma * inv_sigp))
        nev = abs(xn - (1.0 - p.two_mu * ngamma) * y
                  - p.two_mu * err * sigma * inv_sigp)
        if nev < nel:
            if lidx + p.lincr > p.lidx_max:
                lidx = p.lidx_max
            else:
                lidx = max(lidx + p.lincr - p.ldecr, p.lidx_min)
        ngamma = p.gamma * lidx ** 4 * p.den_mult
        w = (1.0 - p.two_mu * ngamma) * w + p.two_mu * err * inv_sigp * reg
        hist = np.concatenate([[xn], hist[:-1]])
    return out * (1.0 if p.notch else p.post_gain), w, lidx


def test_xanr_scan_matches_oracle():
    ch, n, blocks = 2, 256, 4
    rng = np.random.default_rng(9)
    t = np.arange(blocks * n) / C.AUDIO_RATE
    x = (0.3 * np.sin(2 * np.pi * 900.0 * t)[None]
         + 0.1 * rng.standard_normal((ch, blocks * n))).astype(np.float32)
    for notch in (False, True):
        p = NR.XanrParams(notch=notch)
        st0 = NR.xanr_state(p, (ch,))
        st = jax.tree.map(jnp.asarray, st0)
        ys = []
        for b in range(blocks):
            st, y = NR.xanr(p, st, jnp.asarray(x[:, b * n:(b + 1) * n]))
            ys.append(np.asarray(y))
        ys = np.concatenate(ys, axis=-1)
        for c in range(ch):
            one = NR.XanrState(*(np.asarray(f)[c] for f in st0))
            ref, w, lidx = xanr_oracle(p, one, x[c])
            np.testing.assert_allclose(ys[c], ref, rtol=1e-4, atol=1e-5,
                                       err_msg=f"notch={notch}")
            np.testing.assert_allclose(np.asarray(st.w)[c], w, rtol=1e-3,
                                       atol=1e-6)
            assert float(np.asarray(st.lidx)[c]) == lidx
