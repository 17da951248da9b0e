"""LPC impulse noise blanker (JAX).

Re-expression of the reference's experimental noise blanker
(tmr4/T41_SDR `AltNoiseBlanking` `DSP_Fn.cpp:137-362`, by Michael Wild):
per 256-sample audio frame —

  1. order-10 LPC via autocorrelation + Levinson-Durbin,
  2. inverse filtering (whitening) then matched filtering to enhance
     impulses,
  3. threshold at NB_thresh * sqrt(var * lpc_power) to locate impulses,
  4. replace a +-PL window around each impulse with linearly-weighted
     forward/backward LPC predictions.

Batch-first re-architecture: instead of per-impulse pointer surgery, the
detection produces a blank MASK (dilated +-PL); forward and backward
prediction run as two full-frame `lax.scan`s that free-run (predict)
inside masked regions and track the input outside, then blend with the
same linear cross-fades.  Handles any number of impulses, channel
batched.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

ORDER = 10            # NB_taps (DSP_Fn.cpp:26)
IMPULSE_LEN = 7       # NB_impulse_samples
PL = (IMPULSE_LEN - 1) // 2
NB_THRESH = 2.5       # DSP_Fn.cpp:138


def levinson(r: jnp.ndarray):
    """Levinson-Durbin: autocorrelation (..., ORDER+1) -> LPC
    coefficients (..., ORDER+1) with leading 1 (DSP_Fn.cpp:246-275)."""
    r0 = r[..., 0] * (1.0 + 1e-9)
    lpcs = jnp.zeros(r.shape[:-1] + (ORDER + 1,), r.dtype)
    lpcs = lpcs.at[..., 0].set(1.0)
    alfa = r0

    def step(carry, m):
        lpcs, alfa = carry
        idx = jnp.arange(1, ORDER + 1)
        # s = sum_{u=1}^{m-1} lpcs[u] * r[m-u]
        ru = jnp.where((idx < m)[..., :],
                       jnp.take(r, jnp.clip(m - idx, 0, ORDER), axis=-1),
                       0.0)
        lu = jnp.where(idx < m, lpcs[..., 1:], 0.0)
        s = jnp.sum(lu * ru, axis=-1)
        rm = jnp.take(r, m, axis=-1)
        k = -(rm + s) / jnp.maximum(alfa, 1e-30)
        # any[v] = lpcs[v] + k * lpcs[m-v]  for v in 1..m-1
        lrev = jnp.where((idx < m),
                         jnp.take(lpcs, jnp.clip(m - idx, 0, ORDER), axis=-1),
                         0.0)
        newv = lpcs[..., 1:] + k[..., None] * lrev
        upd = jnp.where(idx < m, newv, lpcs[..., 1:])
        upd = jnp.where(idx == m, k[..., None], upd)
        lpcs = lpcs.at[..., 1:].set(upd)
        alfa = alfa * (1.0 - k * k)
        return (lpcs, alfa), None

    (lpcs, _), _ = jax.lax.scan(step, (lpcs, alfa),
                                jnp.arange(1, ORDER + 1))
    return lpcs


def noise_blanker(x: jnp.ndarray, thresh: float = NB_THRESH):
    """x: (..., N) real audio frame(s).  Returns the blanked frames.

    Stateless per frame like the reference (its tiny cross-frame history
    only patches the left boundary; t41x skips detections within ORDER+PL
    of the edges, as the reference effectively does via `search_pos`
    bounds)."""
    n = x.shape[-1]
    # autocorrelation R[0..ORDER]
    lags = []
    for i in range(ORDER + 1):
        lags.append(jnp.sum(x[..., : n - i] * x[..., i:], axis=-1))
    r = jnp.stack(lags, axis=-1)
    lpcs = levinson(r)

    # whitening (reverse-lpc FIR) then matched filter (lpc FIR)
    def fir(sig, taps):
        # causal FIR, taps (..., T) per-channel: do it via explicit lags
        out = jnp.zeros_like(sig)
        for i in range(ORDER + 1):
            shifted = jnp.pad(sig, [(0, 0)] * (sig.ndim - 1) + [(i, 0)]
                              )[..., :n]
            out = out + taps[..., i: i + 1] * shifted
        return out

    rev = lpcs[..., ::-1]
    temp = fir(x, rev)
    temp = fir(temp, lpcs)

    sigma2 = jnp.var(temp, axis=-1, keepdims=True)
    lpc_power = jnp.sum(lpcs[..., :ORDER] ** 2, axis=-1, keepdims=True)
    threshold = thresh * jnp.sqrt(sigma2 * lpc_power)

    # impulse mask, corrected by the filter delay (DSP_Fn.cpp:296) and
    # dilated +-PL
    hits = jnp.abs(temp) > threshold
    hits = jnp.roll(hits, -ORDER, axis=-1)
    guard = jnp.arange(n)
    edge_ok = (guard >= ORDER + PL) & (guard < n - 14)
    hits = hits & edge_ok
    # dilate via max-pool window 2PL+1
    mask = hits
    for s in range(1, PL + 1):
        mask = mask | jnp.roll(hits, s, axis=-1) | jnp.roll(hits, -s, -1)

    # forward predictor: track x outside mask, free-run inside
    a = -lpcs[..., 1:]  # prediction coefficients

    def run_pred(sig, mask_):
        def step(hist, inp):
            xt, m = inp
            pred = jnp.sum(a * hist, axis=-1)
            yt = jnp.where(m, pred, xt)
            hist = jnp.concatenate([yt[..., None], hist[..., :-1]], axis=-1)
            return hist, yt

        hist0 = jnp.zeros(sig.shape[:-1] + (ORDER,), sig.dtype)
        xs = (jnp.moveaxis(sig, -1, 0), jnp.moveaxis(mask_, -1, 0))
        _, ys = jax.lax.scan(step, hist0, xs)
        return jnp.moveaxis(ys, 0, -1)

    fwd = run_pred(x, mask)
    bwd = run_pred(x[..., ::-1], mask[..., ::-1])[..., ::-1]

    # linear cross-fade inside each blanked region: weight by distance
    # to the region edges (the reference's Wfw/Wbw ramps)
    def distance_from_start(m):
        def step(c, mm):
            c = jnp.where(mm, c + 1, 0)
            return c, c
        _, d = jax.lax.scan(step, jnp.zeros(m.shape[:-1], jnp.float32),
                            jnp.moveaxis(m, -1, 0))
        return jnp.moveaxis(d, 0, -1)

    d_fw = distance_from_start(mask)
    d_bw = distance_from_start(mask[..., ::-1])[..., ::-1]
    w_bw = d_fw / jnp.maximum(d_fw + d_bw, 1.0)
    blended = (1.0 - w_bw) * fwd + w_bw * bwd
    return jnp.where(mask, blended, x)
