"""Wideband polyphase channelizer (JAX).

The piece with no reference analog (SURVEY.md §7 phase 6): the reference
receives ONE 192 kHz channel from analog hardware; t41x decomposes a
single wideband I/Q capture (K x 192 kHz wide) into K critically-sampled
192 kHz channels — which then fan out over the mesh's channel axis into
the standard RX chain.

Classic critically-sampled polyphase DFT filter bank.  Derivation:
channel k is decimate-by-K of x[n] e^{-j2pi kn/K} filtered by the
prototype h.  Substituting n = tK+p:

    y_k[m] = sum_p e^{+j2pi kp/K} v_p[m]
    v_p[m] = sum_t h[tK+p] * u_p[m-t],   with  u_p[m] = x[mK - p]

i.e. the commutator feeds the phases in REVERSED order with a
one-sample stagger — that pairing is what makes the per-branch aliases
cancel.  Here the reversal is folded into the coefficients (hp_r) and
the DFT matrix (E2) so the frame tensor is one zero-copy reshape of the
raw stream; the branch FIRs are P contiguous-slice multiply-adds over
(n_out, K) frames and the phase DFT is one (K x K) complex matmul.
"""

from __future__ import annotations

import jax.numpy as jnp

import numpy as np

from t41x import constants as C
from t41x.utils import windows as W


class Channelizer:
    def __init__(self, num_channels: int, taps_per_phase: int = 12,
                 fs_channel: float = C.SAMPLE_RATE):
        self.K = num_channels
        self.P = taps_per_phase
        self.fs_channel = fs_channel
        self.fs_in = num_channels * fs_channel
        n = num_channels * taps_per_phase
        # prototype lowpass: cutoff at the channel Nyquist
        beta = W.kaiser_beta(80.0)
        h = np.sinc(np.arange(n) / num_channels
                    - taps_per_phase / 2) * W.kaiser(n, beta)
        h /= h.sum()
        # polyphase decomposition: hp[p, t] = h[t*K + p]
        self.hp = (h.reshape(taps_per_phase, num_channels).T
                   * num_channels).astype(np.float32)
        # reshape-only layout (see block()): the commutator's reversed
        # phase order is folded into the coefficients and the DFT matrix
        # instead of reversing the data — hp_r[i, t] = hp[K-1-i, t] and
        # E2[k, i] = e^{+j 2pi k (K-1-i) / K}, so the frame tensor is one
        # zero-copy reshape of the raw stream
        self.hp_r = self.hp[::-1, :].copy()
        kk = np.arange(num_channels)
        self.E2 = np.exp(2j * np.pi * np.outer(
            kk, num_channels - 1 - kk) / num_channels).astype(np.complex64)
        # packed REAL form of the phase DFT: with the re/im-stacked
        # branch vector X = [vr | vi] (.., 2K), one real (2K, 2K) matmul
        # produces [ch_r | ch_i] in place of a 4-matmul complex einsum
        Er, Ei = self.E2.real, self.E2.imag
        self.W2 = np.block([[Er.T, Ei.T],
                            [-Ei.T, Er.T]]).astype(np.float32)

    def init_state(self, batch: tuple[int, ...] = ()) -> np.ndarray:
        """(..., P*K - 1) raw-sample history (commutator + FIR tails)."""
        return np.zeros(batch + (self.P * self.K - 1,), np.complex64)

    def block(self, state: jnp.ndarray, x: jnp.ndarray):
        """x: (..., N) wideband complex at K*fs, N divisible by K.
        Returns (state, channels) with channels (..., K, N/K); channel k
        is centered at +k*fs_channel (k > K/2: negative frequencies)."""
        K, P = self.K, self.P
        L = P * K - 1
        n_out = x.shape[-1] // K
        xc = jnp.concatenate([state, x], axis=-1)  # xc[j] = x[j - L]
        new_state = xc[..., -L:]

        # frame tensor U[mm, i] = x[(mm - P + 1)K + i - K + 1]: ONE
        # zero-copy reshape — the commutator reversal lives in hp_r/E2,
        # so no per-tap strided slice or data reversal is needed (the
        # original formulation's 12 reversed strided slices dominated
        # the whole RX chain's cost on chip)
        nf = n_out + P - 1
        U = xc[..., : nf * K].reshape(x.shape[:-1] + (nf, K))
        # re/im packed along the lane axis: the branch FIR runs on a
        # (nf, 2K) real buffer (full VPU lanes at K=64) and feeds the
        # packed DFT matmul directly
        U2 = jnp.concatenate([U.real, U.imag], axis=-1)   # (.., nf, 2K)
        hp2 = jnp.asarray(np.tile(self.hp_r[:, None], (2, 1, 1))
                          .reshape(2 * K, P))             # (2K, P)
        v = hp2[:, 0] * U2[..., P - 1: P - 1 + n_out, :]
        for t in range(1, P):
            v = v + hp2[:, t] * U2[..., P - 1 - t: P - 1 - t + n_out, :]

        # phase DFT: ONE real (2K, 2K) matmul [vr|vi] -> [ch_r|ch_i]
        ch2 = jnp.matmul(v, jnp.asarray(self.W2))
        ch = (ch2[..., :K] + 1j * ch2[..., K:]).astype(jnp.complex64)
        return new_state, jnp.swapaxes(ch, -1, -2)

    def channel_center_hz(self, k: int) -> float:
        """Center frequency of channel k in the wideband capture."""
        k = k if k <= self.K // 2 else k - self.K
        return k * self.fs_channel
