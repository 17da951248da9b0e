"""Synchronous AM (SAM) PLL demodulation (JAX).

WDSP-style PLL phase detector with 2nd-order loop filter and fade-leveler
DC insertion (reference `AMDecodeSAM` `Demod.cpp:40-139`, from Warren
Pratt's WDSP).  Per-sample `lax.scan`; channels ride the batch axis.

Loop constants follow `Demod.cpp:13-23`: zeta = 0.65, omegaN (PLL
bandwidth) default 200, pll_fmax default 4000 (`gwv.cpp:64-65`).
The fade-leveler accumulators reset every block, like the reference's
function-local variables.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from t41x import constants as C


class SAMParams(NamedTuple):
    g1: float
    g2: float
    omega_min: float
    omega_max: float
    mtauR: float
    onem_mtauR: float
    mtauI: float
    onem_mtauI: float
    fade_leveler: int


def sam_params(omega_n: float = 200.0, pll_fmax: float = 4000.0,
               zeta: float = 0.65, rate: float = C.AUDIO_RATE,
               fade_leveler: int = 1) -> SAMParams:
    dt = 1.0 / rate
    g1 = 1.0 - np.exp(-2.0 * omega_n * zeta * dt)
    g2 = -g1 + 2.0 * (1.0 - np.exp(-omega_n * zeta * dt)
                      * np.cos(omega_n * dt * np.sqrt(1.0 - zeta * zeta)))
    # NOTE: the reference computes tauR/tauI decay constants with integer
    # division (`exp(-1/24000 * tau)` == exp(0) == 1 in C), effectively
    # freezing its fade-leveler DC trackers.  t41x uses the intended
    # exp(-dt/tau) behavior.
    tauR, tauI = 0.02, 1.4
    mtauR = np.exp(-dt / tauR)
    mtauI = np.exp(-dt / tauI)
    return SAMParams(float(g1), float(g2),
                     float(-2.0 * np.pi * pll_fmax * dt),
                     float(2.0 * np.pi * pll_fmax * dt),
                     float(mtauR), float(1 - mtauR),
                     float(mtauI), float(1 - mtauI), fade_leveler)


class SAMState(NamedTuple):
    phzerror: jnp.ndarray
    fil_out: jnp.ndarray
    omega2: jnp.ndarray
    dc: jnp.ndarray          # fade-leveler audio DC tracker
    dc_insert: jnp.ndarray   # fade-leveler carrier-level tracker


def sam_state(channels: tuple[int, ...] = ()) -> SAMState:
    z = lambda: np.zeros(channels, np.float32)  # noqa: E731
    return SAMState(z(), z(), z(), z(), z())


# atan(sqrt(u))/sqrt(u) on u in [0, 1] as a Chebyshev series: a
# ~1e-7-rad atan2 from multiply-adds alone (the reference itself uses a
# far coarser polynomial, ApproxAtan2 Demod.cpp:148)
_ATAN_COEF = np.polynomial.chebyshev.Chebyshev.interpolate(
    lambda u: np.arctan(np.sqrt(np.maximum(u, 1e-30)))
    / np.sqrt(np.maximum(u, 1e-30)), 14, domain=[0.0, 1.0]
).convert(kind=np.polynomial.Polynomial).coef.astype(np.float32)


def atan2_poly(y, x):
    """Four-quadrant arctangent, |err| ~ 1e-7 rad, branchless."""
    ay, ax = jnp.abs(y), jnp.abs(x)
    hi = jnp.maximum(ax, ay)
    lo = jnp.minimum(ax, ay)
    z = lo / jnp.maximum(hi, 1e-30)          # in [0, 1]
    u = z * z
    acc = jnp.float32(_ATAN_COEF[-1])
    for c in _ATAN_COEF[-2::-1]:
        acc = acc * u + jnp.float32(c)
    t = z * acc                               # atan(z)
    t = jnp.where(ay > ax, jnp.float32(np.pi / 2) - t, t)
    t = jnp.where(x < 0, jnp.float32(np.pi) - t, t)
    return jnp.where(y < 0, -t, t)


def sam_step(p: SAMParams, carry, i, q):
    """One PLL sample update on arbitrarily-shaped channel tiles."""
    phz0, fil, om2, dc, dci = carry
    s, co = jnp.sin(phz0), jnp.cos(phz0)
    ai, bi = co * i, s * i
    aq, bq = co * q, s * q
    corr_re = ai + bq
    corr_im = -bi + aq
    audio = (ai - bi) + (aq + bq)
    if p.fade_leveler:
        dc = p.mtauR * dc + p.onem_mtauR * audio
        dci = p.mtauI * dci + p.onem_mtauI * corr_re
        audio = audio + dci - dc
    det = atan2_poly(corr_im, corr_re)
    del_out = fil
    om2 = jnp.clip(om2 + p.g2 * det, p.omega_min, p.omega_max)
    fil = p.g1 * det + om2
    phz = jnp.mod(phz0 + del_out, 2.0 * jnp.pi)
    return (phz, fil, om2, dc, dci), audio


def sam_demod(params: SAMParams, st: SAMState, y: jnp.ndarray):
    """y: (..., N) complex filtered baseband.
    Returns (new_state, audio, carrier_offset_hz)."""
    p = params

    # fade-leveler accumulators carried across blocks (the reference
    # declares them function-local, but its integer-division tau bug
    # freezes them anyway — carrying is the intended WDSP behavior)
    carry0 = (st.phzerror, st.fil_out, st.omega2, st.dc, st.dc_insert)

    def step(c, zn):
        return sam_step(p, c, zn.real, zn.imag)

    ys = jnp.moveaxis(y, -1, 0)
    cf, audio = jax.lax.scan(step, carry0, ys)
    audio = jnp.moveaxis(audio, 0, -1)
    carrier_hz = cf[2] * C.AUDIO_RATE / (2.0 * jnp.pi)
    return SAMState(*cf), audio, carrier_hz
