"""Per-hop reference parity for the batched NR formulations.

`t41x.dsp.nr.kim_nr` / `spectral_nr` are behavioral REWRITES of the
straightforward per-hop algorithms (shift registers -> order-free rings,
chained per-hop FFTs -> one batched dense rDFT, per-width box smoothing
-> shared cumsum).  The golden/SNR tests only check statistical
behavior; these tests pin the rewrites sample-exact (to fp32) against a
straightforward per-hop numpy transcription of the same math, streamed
over several blocks with carried state — so a box-filter offset,
ring-cursor slip, or hop-ordering regression fails loudly.

Reference algorithms: Kim & Ruwisch (`Noise.cpp:108-311`), UHSDR
spectral subtraction (`Noise.cpp:379-645`).
"""

import jax
import jax.numpy as jnp
import numpy as np

from t41x.dsp import nr as NR

L = NR.NR_FFT_L   # 256
HOP = NR.HOP      # 128


def _hann():
    i = np.arange(L)
    return (0.5 * (1.0 - np.cos(2 * np.pi * i / (L - 1)))).astype(np.float32)


def _signal(ch, blocks, seed):
    rng = np.random.default_rng(seed)
    n = blocks * L
    t = np.arange(n, dtype=np.float64) / 24000.0
    tone = 0.4 * np.sin(2 * np.pi * 700.0 * t)[None]
    amp = 0.5 + 0.5 * rng.random((ch, 1))
    noise = 0.2 * rng.standard_normal((ch, n))
    return (amp * tone + noise).astype(np.float32)


# ----------------------------------------------------------------------
# naive per-hop Kim NR (shift registers, one fft per hop)
# ----------------------------------------------------------------------

class NaiveKim:
    def __init__(self, p, ch):
        self.p = p
        self.last_sample = np.zeros((ch, HOP), np.float32)
        self.last_ifft = np.zeros((ch, HOP), np.float32)
        self.X = np.zeros((ch, HOP, 3), np.float32)   # shift register
        self.E = np.zeros((ch, HOP, 15), np.float32)
        self.Gts = np.zeros((ch, HOP), np.float32)

    def hop(self, x_hop):
        p = self.p
        w = _hann()
        frame = np.concatenate([self.last_sample, x_hop], axis=-1) * w
        S = np.fft.fft(frame.astype(np.float64), axis=-1)
        power = (np.abs(S[..., :HOP]) ** 2).astype(np.float32)

        # shift registers (newest last)
        self.X = np.concatenate([self.X[..., 1:], power[..., None]], -1)
        E_new = np.mean(self.X, axis=-1, dtype=np.float32)
        self.E = np.concatenate([self.E[..., 1:], E_new[..., None]], -1)
        M = np.min(self.E, axis=-1)

        T = power / np.maximum(M, np.float32(1e-30))
        lam = np.where(T > p.psi, M, E_new)
        G = np.maximum(1.0 - lam / np.maximum(E_new, 1e-30),
                       0.0).astype(np.float32)
        bins = np.arange(HOP)
        in_band = (bins >= p.vad_low) & (bins < p.vad_high)
        G = np.where(in_band, G, 0.0).astype(np.float32)
        self.Gts = (p.alpha * self.Gts + (1.0 - p.alpha) * G
                    ).astype(np.float32)
        b, omb = p.beta, 1.0 - 2.0 * p.beta
        left = np.concatenate([self.Gts[..., :1], self.Gts[..., :-1]], -1)
        right = np.concatenate([self.Gts[..., 1:], self.Gts[..., -1:]], -1)
        Gs = (b * left + omb * self.Gts + b * right).astype(np.float32)
        fg = np.concatenate([Gs, Gs[..., ::-1]], axis=-1)

        out = np.fft.ifft(S * fg, axis=-1).real.astype(np.float32)
        a = out[..., :HOP] + self.last_ifft
        self.last_ifft = out[..., HOP:]
        self.last_sample = x_hop
        return a

    def block(self, x):
        a0 = self.hop(x[..., :HOP])
        a1 = self.hop(x[..., HOP:])
        return np.concatenate([a0, a1], axis=-1) * self.p.post_gain


def test_kim_nr_matches_per_hop_reference():
    p = NR.kim_params(200.0, 3000.0)
    ch, blocks = 3, 6
    x = _signal(ch, blocks, seed=21)

    st = jax.tree.map(jnp.asarray, NR.kim_state((ch,)))
    naive = NaiveKim(p, ch)
    for bi in range(blocks):
        blk = x[:, bi * L:(bi + 1) * L]
        st, y = NR.kim_nr(p, st, jnp.asarray(blk))
        y_ref = naive.block(blk)
        np.testing.assert_allclose(np.asarray(y), y_ref, rtol=2e-4,
                                   atol=2e-4, err_msg=f"block {bi}")
    # carried state must agree too (rings vs shift registers: compare
    # order-free reductions, the smoothed gain, and the OLA tail)
    # t41x stores rings slot-leading ((..., slots, bins)); the naive
    # shift registers are (..., bins, slots) — compare order-free
    np.testing.assert_allclose(
        np.sort(np.moveaxis(np.asarray(st.X), -2, -1), -1),
        np.sort(naive.X, -1), rtol=2e-3, atol=1e-5)
    np.testing.assert_allclose(
        np.sort(np.moveaxis(np.asarray(st.E), -2, -1), -1),
        np.sort(naive.E, -1), rtol=2e-3, atol=1e-5)
    np.testing.assert_allclose(np.asarray(st.Gts), naive.Gts,
                               rtol=2e-3, atol=1e-5)
    np.testing.assert_allclose(np.asarray(st.last_ifft), naive.last_ifft,
                               rtol=2e-3, atol=1e-4)


def test_kim_nr_ring_wraparound_matches_per_hop_reference():
    """Nine blocks = 18 hops, past the 15-slot minimum-statistics ring:
    the order-free ring and its cursor must keep matching the shift
    registers after the cursor wraps."""
    p = NR.kim_params(200.0, 3000.0)
    ch, blocks = 5, 9
    x = _signal(ch, blocks, seed=23)
    st = jax.tree.map(jnp.asarray, NR.kim_state((ch,)))
    naive = NaiveKim(p, ch)
    for bi in range(blocks):
        blk = x[:, bi * L:(bi + 1) * L]
        st, y = NR.kim_nr(p, st, jnp.asarray(blk))
        np.testing.assert_allclose(np.asarray(y), naive.block(blk),
                                   rtol=2e-4, atol=2e-4,
                                   err_msg=f"block {bi}")
    np.testing.assert_allclose(
        np.sort(np.moveaxis(np.asarray(st.E), -2, -1), -1),
        np.sort(naive.E, -1), rtol=2e-3, atol=1e-5)
    assert int(np.asarray(st.idx)[0]) == 2 * blocks


# ----------------------------------------------------------------------
# naive per-hop spectral NR
# ----------------------------------------------------------------------

class NaiveSpectral:
    def __init__(self, p, ch):
        self.p = p
        self.last_sample = np.zeros((ch, HOP), np.float32)
        self.last_ifft = np.zeros((ch, HOP), np.float32)
        self.xt = np.full((ch, HOP), 1e-6, np.float32)
        self.pslp = np.full((ch, HOP), 0.5, np.float32)
        self.hk_old = np.ones((ch, HOP), np.float32)
        self.frames = np.zeros((ch,), np.int64)
        i = np.arange(L)
        self.window = np.sqrt(
            0.5 * (1.0 - np.cos(2 * np.pi * i / (L - 1)))).astype(np.float32)

    def hop(self, x_hop):
        p = self.p
        frame = np.concatenate([self.last_sample, x_hop], -1) * self.window
        S = np.fft.fft(frame.astype(np.float64), axis=-1)
        X = (np.abs(S[..., :HOP]) ** 2).astype(np.float32)

        ax = np.float32(np.exp(-p.tinc / p.tax))
        ap = np.float32(np.exp(-p.tinc / p.tap))
        xih1 = np.float32(10.0 ** (p.asnr_db / 10.0))
        xih1r = np.float32(1.0 / (1.0 + xih1) - 1.0)
        pfac = np.float32((1.0 / p.pspri - 1.0) * (1.0 + xih1))
        snr_prio_min = np.float32(10.0 ** (p.snr_prio_min_db / 20.0))

        initializing = self.frames[..., None] < p.init_frames
        xt_init = self.xt + np.float32(0.05 * p.psini) * X

        ph1y = 1.0 / (1.0 + pfac * np.exp(np.clip(
            xih1r * X / np.maximum(self.xt, 1e-30), -50.0, 50.0)))
        pslp = ap * self.pslp + (1.0 - ap) * ph1y
        ph1y = np.where(pslp > p.psthr, np.float32(1.0 - p.pnsaf),
                        np.minimum(ph1y, 1.0))
        xtr = (1.0 - ph1y) * X + ph1y * self.xt
        xt_run = ax * self.xt + (1.0 - ax) * xtr

        xt = np.where(initializing, xt_init, xt_run).astype(np.float32)
        pslp = np.where(initializing, self.pslp, pslp).astype(np.float32)

        snr_post = np.clip(X / np.maximum(xt, 1e-30), snr_prio_min,
                           1000.0).astype(np.float32)
        snr_prio = np.maximum(
            p.alpha * self.hk_old
            + (1.0 - p.alpha) * np.maximum(snr_post - 1.0, 0.0),
            0.0).astype(np.float32)
        v = snr_prio * snr_post / (1.0 + snr_prio)
        G = (np.sqrt(np.maximum(0.7212 * v + v * v, 0.0))
             / snr_post).astype(np.float32)
        hk_old = (snr_post * G * G).astype(np.float32)

        bins = np.arange(HOP)
        in_band = (bins >= p.vad_low) & (bins < p.vad_high)
        pre = np.sum(np.where(in_band, X, 0.0), axis=-1)
        post = np.sum(np.where(in_band, G * G * X, 0.0), axis=-1)
        ratio = post / np.maximum(pre, 1e-30)
        nn_f = np.where(ratio > p.power_threshold, 0.0,
                        np.round(p.width * (1.0 - ratio / p.power_threshold)))
        # naive per-channel centered box over edge-replicated gains
        G_sm = G.copy()
        for c in range(G.shape[0]):
            nn = int(np.clip(nn_f[c], 0, 4))
            width = [1, 3, 5, 7, 9][nn]
            if width > 1:
                gp = np.concatenate([np.repeat(G[c, :1], 4), G[c],
                                     np.repeat(G[c, -1:], 4)])
                sm = np.convolve(gp, np.ones(width, np.float32) / width,
                                 mode="same")[4:4 + HOP]
                G_sm[c] = sm.astype(np.float32)
        G = np.where(in_band, G_sm, G).astype(np.float32)
        fg = np.concatenate([G, G[..., ::-1]], axis=-1)

        out = (np.fft.ifft(S * fg, axis=-1).real.astype(np.float32)
               * self.window)
        a = out[..., :HOP] + self.last_ifft
        a = np.where(initializing, x_hop, a)
        self.last_ifft = out[..., HOP:]
        self.last_sample = x_hop
        self.xt, self.pslp, self.hk_old = xt, pslp, hk_old
        self.frames = self.frames + 1
        return a.astype(np.float32)

    def block(self, x):
        a0 = self.hop(x[..., :HOP])
        a1 = self.hop(x[..., HOP:])
        return np.concatenate([a0, a1], axis=-1)


def test_spectral_nr_matches_per_hop_reference():
    p = NR.spectral_params(200.0, 3000.0)
    ch = 3
    # long enough to leave the init phase (init_frames hops) well behind
    blocks = p.init_frames // 2 + 8
    x = _signal(ch, blocks, seed=33)

    st = jax.tree.map(jnp.asarray, NR.spectral_state((ch,)))
    naive = NaiveSpectral(p, ch)
    for bi in range(blocks):
        blk = x[:, bi * L:(bi + 1) * L]
        st, y = NR.spectral_nr(p, st, jnp.asarray(blk))
        y_ref = naive.block(blk)
        np.testing.assert_allclose(np.asarray(y), y_ref, rtol=2e-3,
                                   atol=2e-3, err_msg=f"block {bi}")
    np.testing.assert_allclose(np.asarray(st.xt), naive.xt,
                               rtol=5e-3, atol=1e-5)
    np.testing.assert_allclose(np.asarray(st.hk_old), naive.hk_old,
                               rtol=5e-3, atol=1e-4)
    np.testing.assert_allclose(np.asarray(st.last_ifft), naive.last_ifft,
                               rtol=5e-3, atol=1e-4)
