"""14-band audio equalizer (JAX).

Re-expression of the reference's receive/transmit EQ (tmr4/T41_SDR
`DoReceiveEQ` `Filter.cpp:117-165`, `DoExciterEQ` `:176-224`): 14 parallel
4-pole band-pass biquad cascades at 1/3-octave centers
(fc_i = 125 * 2^((i+1)/3), 198 Hz ... 4 kHz, `FIR.cpp:279-371`), each
scaled by the user's per-band gain — the reference alternates the sign of
odd bands to compensate the cascades' phase inversion — and summed.

The band filters are designed at trace time (4th-order Butterworth
band-pass via bilinear transform) rather than shipped as baked tables;
they match the reference filters' centers and ~0.3 fc bandwidths.

Structure: all 14 cascades are composed at trace time into ONE
chunk-parallel state-space operator (`iir.compose_cascade_ops`): per
K-sample chunk, [x | all 56 states] hits two precomputed matmuls
producing every band's output and the next states — 8 matmul steps per
256-sample block instead of a 256-step per-sample scan with scattered
state updates.
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp

from t41x import constants as C
from t41x.dsp import iir

NUM_BANDS = 14


def band_centers() -> np.ndarray:
    i = np.arange(1, NUM_BANDS + 1)
    return 125.0 * 2.0 ** ((i + 1) / 3.0)


def design_eq_bands(rate: float = C.AUDIO_RATE):
    """Returns (b, a) of shape (14, S, 3): per-band biquad cascades."""
    from scipy import signal

    bs, as_ = [], []
    for fc in band_centers():
        bw = 0.3045 * fc
        lo = max(fc - bw / 2.0, 10.0)
        hi = min(fc + bw / 2.0, rate / 2.0 * 0.98)
        sos = signal.butter(2, [lo, hi], btype="bandpass", fs=rate,
                            output="sos")
        bs.append(sos[:, :3])
        as_.append(sos[:, 3:])
    return (np.asarray(bs, np.float32), np.asarray(as_, np.float32))


_CHUNK = 32


class EQDesign:
    def __init__(self, rate: float = C.AUDIO_RATE, chunk: int = _CHUNK):
        self.b, self.a = design_eq_bands(rate)
        self.stages = S = self.b.shape[1]
        self.chunk = K = int(chunk)
        ns = 2 * S                               # states per band (4)
        NS = NUM_BANDS * ns                      # all states (56)
        # combined chunk operator over [x(K) | s(56)]:
        #   y_all  = z @ Wy   (K+56, 14*K)   every band's chunk output
        #   s_next = z @ Ws   (K+56, 56)
        Wy = np.zeros((K + NS, NUM_BANDS * K))
        Ws = np.zeros((K + NS, NS))
        for bi in range(NUM_BANDS):
            L, R, G, AK = iir.compose_cascade_ops(self.b[bi], self.a[bi], K)
            yc = slice(bi * K, (bi + 1) * K)
            sc = slice(K + bi * ns, K + (bi + 1) * ns)
            Wy[:K, yc] = L.T
            Wy[sc, yc] = R.T
            Ws[:K, bi * ns:(bi + 1) * ns] = G
            Ws[sc, bi * ns:(bi + 1) * ns] = AK.T
        self.Wy = Wy.astype(np.float32)
        self.Ws = Ws.astype(np.float32)

    def init_state(self, channels: tuple[int, ...] = ()) -> np.ndarray:
        """(..., 14, S, 2) biquad states (per-band df2T cascades —
        unchanged layout, checkpoint-compatible)."""
        return np.zeros(channels + (NUM_BANDS, self.stages, 2), np.float32)

    def apply(self, state: jnp.ndarray, x: jnp.ndarray,
              gains: jnp.ndarray):
        """x: (..., N) audio; gains: (..., 14) in 0..1 (user setting/100).
        Returns (state, y).  Odd bands are negated like the reference
        (`Filter.cpp:136-149`)."""
        import jax

        K = self.chunk
        lead = x.shape[:-1]
        n = x.shape[-1]
        assert n % K == 0, (n, K)
        ns = 2 * self.stages
        NS = NUM_BANDS * ns
        Wy = jnp.asarray(self.Wy)
        Ws = jnp.asarray(self.Ws)
        s0 = state.reshape(lead + (NS,)).astype(x.dtype)

        def step(s, xc):
            z = jnp.concatenate([xc, s], axis=-1)      # (..., K+56)
            return z @ Ws, z @ Wy                      # next state, outs

        xs = jnp.moveaxis(x.reshape(lead + (n // K, K)), -2, 0)
        s_f, ys = jax.lax.scan(step, s0, xs)           # ys (nc, ..., 14K)
        yb = jnp.moveaxis(ys, 0, -2)                   # (..., nc, 14K)
        yb = yb.reshape(lead + (n // K, NUM_BANDS, K))
        yb = jnp.moveaxis(yb, -2, -3).reshape(lead + (NUM_BANDS, n))

        signs = jnp.asarray([(-1.0) ** (i + 1) * -1.0
                             for i in range(NUM_BANDS)], x.dtype)
        # signs: band1 -, band2 +, band3 -, ... (Filter.cpp:136-149)
        y = jnp.sum(yb * (signs * gains)[..., None], axis=-2)
        return s_f.reshape(lead + (NUM_BANDS, self.stages, 2)), y
