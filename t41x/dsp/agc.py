"""WDSP-style AGC (JAX).

Faithful functional re-expression of the reference's 5-state
attack/decay/hang AGC (tmr4/T41_SDR `DSP_Fn.cpp:368-632`, itself from
Warren Pratt's WDSP): a per-sample look-ahead delay line of
`attack_buffsize` complex samples, a sliding-window peak detector over
that line, fast/hang back-averages, and a state machine
{0: attack/track, 1: fast decay, 2: hang, 3: decay, 4: hang decay}
driving a log-domain gain slope.

The per-sample dependency is inherent (gain at n depends on gain at n-1),
so this is a `lax.scan`; channels ride a leading batch axis so every
scan step is a wide vector op.  The reference's lazily-maintained
`ring_max` is replaced by an exact sliding-window max over the delay
line, which is what the lazy version computes.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from t41x import constants as C


class AGCParams(NamedTuple):
    """Static (trace-time) AGC constants — reference `AGCPrep` /
    `AGCLoadValues` (`DSP_Fn.cpp:368-468`)."""
    mode: int              # 0 off, 1 long, 2 slow, 3 med, 4 fast
    attack_buffsize: int
    attack_mult: float
    decay_mult: float
    fast_decay_mult: float
    fast_backmult: float
    onemfast_backmult: float
    hang_backmult: float
    onemhang_backmult: float
    hang_decay_mult: float
    hang_counter_init: int
    out_target: float
    min_volts: float
    slope_constant: float
    inv_max_input: float
    hang_level: float
    hang_enable: int
    pop_ratio: float
    fixed_gain: float


_MODE_TABLE = {  # mode -> (hangtime s, tau_decay s), DSP_Fn.cpp:378-402
    1: (2.000, 2.000),
    2: (1.000, 0.500),
    3: (0.000, 0.250),
    4: (0.000, 0.050),
}


def agc_params(mode: int = 1, agc_thresh_db: float = 20.0,
               sample_rate: float = C.AUDIO_RATE) -> AGCParams:
    if mode == 0:
        return AGCParams(0, 1, *([0.0] * 8), 0, 1.0, 0.0, 1.0, 1.0, 0.0, 0,
                         5.0, 20.0)
    hangtime, tau_decay = _MODE_TABLE[mode]
    tau_attack = 0.001
    n_tau = 4.0
    max_input = 1.0
    out_targ = 1.0
    var_gain = 1.5
    tau_fast_backaverage = 0.250
    tau_fast_decay = 0.005
    tau_hang_backmult = 0.500
    hang_thresh = 0.250
    tau_hang_decay = 0.100

    max_gain = 10.0 ** (agc_thresh_db / 20.0)
    attack_buffsize = int(np.ceil(sample_rate * n_tau * tau_attack))
    attack_mult = 1.0 - np.exp(-1.0 / (sample_rate * tau_attack))
    decay_mult = 1.0 - np.exp(-1.0 / (sample_rate * tau_decay))
    fast_decay_mult = 1.0 - np.exp(-1.0 / (sample_rate * tau_fast_decay))
    fast_backmult = 1.0 - np.exp(-1.0 / (sample_rate * tau_fast_backaverage))
    hang_backmult = 1.0 - np.exp(-1.0 / (sample_rate * tau_hang_backmult))
    hang_decay_mult = 1.0 - np.exp(-1.0 / (sample_rate * tau_hang_decay))

    out_target = out_targ * (1.0 - np.exp(-n_tau)) * 0.9999
    min_volts = out_target / (var_gain * max_gain)
    tmp = np.log10(out_target / (max_input * var_gain * max_gain))
    if tmp == 0.0:
        tmp = 1e-16
    slope_constant = (out_target * (1.0 - 1.0 / var_gain)) / tmp
    tmp = 10.0 ** ((hang_thresh - 1.0) / 0.125)
    hang_level = (max_input * tmp
                  + (out_target / (var_gain * max_gain)) * (1.0 - tmp)) * 0.637

    return AGCParams(
        mode=mode,
        attack_buffsize=attack_buffsize,
        attack_mult=float(attack_mult),
        decay_mult=float(decay_mult),
        fast_decay_mult=float(fast_decay_mult),
        fast_backmult=float(fast_backmult),
        onemfast_backmult=float(1.0 - fast_backmult),
        hang_backmult=float(hang_backmult),
        onemhang_backmult=float(1.0 - hang_backmult),
        hang_decay_mult=float(hang_decay_mult),
        hang_counter_init=int(hangtime * sample_rate),
        out_target=float(out_target),
        min_volts=float(min_volts),
        slope_constant=float(slope_constant),
        inv_max_input=float(1.0 / max_input),
        hang_level=float(hang_level),
        hang_enable=1,
        pop_ratio=5.0,
        fixed_gain=20.0,
    )


class AGCState(NamedTuple):
    """Carried AGC state (pytree).  Leading dims = channel batch."""
    ring: jnp.ndarray       # (..., B) complex64 delay line, [0] oldest
    abs_ring: jnp.ndarray   # (..., B) float32 magnitudes
    volts: jnp.ndarray      # (...,)
    save_volts: jnp.ndarray
    fast_backaverage: jnp.ndarray
    hang_backaverage: jnp.ndarray
    hang_counter: jnp.ndarray  # (...,) int32
    decay_type: jnp.ndarray    # (...,) int32
    state: jnp.ndarray         # (...,) int32


def agc_state(params: AGCParams, channels: tuple[int, ...] = ()) -> AGCState:
    B = params.attack_buffsize
    z = lambda dt=np.float32: np.zeros(channels, dt)  # noqa: E731
    return AGCState(
        ring=np.zeros(channels + (B,), np.complex64),
        abs_ring=np.zeros(channels + (B,), np.float32),
        volts=z(), save_volts=z(), fast_backaverage=z(),
        hang_backaverage=z(),
        hang_counter=z(np.int32), decay_type=z(np.int32),
        state=z(np.int32),
    )


def _cummax_logshift(ch: jnp.ndarray, reverse: bool = False) -> jnp.ndarray:
    """Within-chunk cumulative max over the last axis via log2(width)
    shifted-max passes: ~7 elementwise maxes of statically-shifted
    slices, which fuse, in place of `lax.cummax`'s scan."""
    w = ch.shape[-1]
    s = 1
    while s < w:
        if reverse:
            shifted = jnp.concatenate([ch[..., s:], ch[..., -s:]], axis=-1)
            shifted = jnp.where(
                np.arange(w) < w - s, shifted, -np.inf)
        else:
            shifted = jnp.concatenate([ch[..., :s], ch[..., :-s]], axis=-1)
            shifted = jnp.where(np.arange(w) >= s, shifted, -np.inf)
        ch = jnp.maximum(ch, shifted)
        s *= 2
    return ch


def _sliding_window_max(a: jnp.ndarray, width: int) -> jnp.ndarray:
    """Exact sliding-window maximum over the last axis, fully parallel
    (van Herk / Gil-Werman: chunked prefix+suffix cummax).

    a: (..., L) -> (..., L - width + 1) with out[i] = max(a[..., i:i+width]).
    """
    L = a.shape[-1]
    n_out = L - width + 1
    n_chunks = -(-L // width)
    pad = n_chunks * width - L
    if pad:
        a = jnp.concatenate(
            [a, jnp.full(a.shape[:-1] + (pad,), -jnp.inf, a.dtype)], axis=-1)
    ch = a.reshape(a.shape[:-1] + (n_chunks, width))
    pref = _cummax_logshift(ch)
    suff = _cummax_logshift(ch, reverse=True)
    pref = pref.reshape(a.shape)
    suff = suff.reshape(a.shape)
    return jnp.maximum(suff[..., :n_out],
                       pref[..., width - 1: width - 1 + n_out])


def agc_step(p: AGCParams, carry, rm, ao):
    """One AGC sample update (the 5-state attack/decay/hang machine) on
    arbitrarily-shaped channel tiles.  Shared by the lax.scan path below
    and the Triton kernel (`t41x/kernels/agc_triton.py`); the scalar
    oracle test pins its semantics."""
    (volts, save_volts, fast_backaverage, hang_backaverage,
     hang_counter0, decay_type, state) = carry

    fast_back = p.fast_backmult * ao + p.onemfast_backmult * fast_backaverage
    hang_back = p.hang_backmult * ao + p.onemhang_backmult * hang_backaverage
    hang_counter = jnp.maximum(hang_counter0 - 1, 0)
    diff = rm - volts
    attack = rm >= volts

    # --- attack branch (any state -> 0) ---
    att_volts = volts + diff * p.attack_mult
    att_save = jnp.where(state >= 2, volts, save_volts)

    # --- release branches per state ---
    s0_fast = volts > p.pop_ratio * fast_back
    s0_hang = (p.hang_enable == 1) & (hang_back > p.hang_level)
    s0_state = jnp.where(s0_fast, 1, jnp.where(s0_hang, 2, 3))
    s0_volts = jnp.where(
        s0_fast, volts + diff * p.fast_decay_mult,
        jnp.where(s0_hang, volts, volts + diff * p.decay_mult))
    s0_hc = jnp.where(s0_hang & ~s0_fast, p.hang_counter_init, hang_counter)
    s0_dt = jnp.where(s0_fast, decay_type,
                      jnp.where(s0_hang, 1, 0)).astype(jnp.int32)

    s1_fast = volts > save_volts
    s1_hang = hang_counter > 0
    s1_state = jnp.where(
        s1_fast, 1, jnp.where(s1_hang, 2,
                              jnp.where(decay_type == 0, 3, 4)))
    s1_volts = jnp.where(
        s1_fast, volts + diff * p.fast_decay_mult,
        jnp.where(s1_hang, volts,
                  jnp.where(decay_type == 0,
                            volts + diff * p.decay_mult,
                            volts + diff * p.hang_decay_mult)))

    s2_done = hang_counter == 0
    s2_state = jnp.where(s2_done, 4, 2)
    s2_volts = jnp.where(s2_done, volts + diff * p.hang_decay_mult, volts)

    s3_volts = volts + diff * p.decay_mult * 0.05
    s4_volts = volts + diff * p.hang_decay_mult

    # nested wheres rather than jnp.select: identical first-true-wins
    # semantics, and every kernel route lowers select_n
    is0, is1, is2, is3 = (state == 0), (state == 1), (state == 2), (state == 3)
    rel_volts = jnp.where(
        is0, s0_volts, jnp.where(
            is1, s1_volts, jnp.where(
                is2, s2_volts, jnp.where(is3, s3_volts, s4_volts))))
    rel_state = jnp.where(
        is0, s0_state, jnp.where(
            is1, s1_state, jnp.where(is2, s2_state, state))).astype(jnp.int32)
    rel_hc = jnp.where(state == 0, s0_hc, hang_counter).astype(jnp.int32)
    rel_dt = jnp.where(state == 0, s0_dt, decay_type).astype(jnp.int32)

    volts = jnp.where(attack, att_volts, rel_volts)
    state = jnp.where(attack, 0, rel_state).astype(jnp.int32)
    save_volts = jnp.where(attack, att_save, save_volts)
    hang_counter = jnp.where(attack, hang_counter, rel_hc)
    decay_type = jnp.where(attack, decay_type, rel_dt)

    volts = jnp.maximum(volts, p.min_volts)
    return (volts, save_volts, fast_back, hang_back, hang_counter,
            decay_type, state)


def agc_apply(params: AGCParams, st: AGCState, x: jnp.ndarray,
              kernel: str | None = None):
    """Apply AGC to a complex block.

    x: (..., N) complex (I + jQ at audio rate)
    Returns (new_state, y) with y complex and delayed by attack_buffsize
    samples (the look-ahead delay line, like the reference).

    Everything that does not depend on the gain recurrence is hoisted
    out of the sample loop: the look-ahead delay (a slice of
    [carried ring | block]), the sliding-window peak (parallel chunked
    cummax), and the final delayed multiply.  The loop itself carries
    only seven per-channel scalars (volts, averages, counters, state).
    `kernel` picks how the loop runs: None is a `lax.scan`, "triton"
    the Pallas-Triton kernel (`t41x.kernels.agc_triton`) compiled for
    the GPU, "interpret" that kernel in the Pallas interpreter.
    Semantics are unchanged vs the scalar oracle
    (`tests/test_agc_oracle.py`).
    """
    if params.mode == 0:
        return st, params.fixed_gain * x

    p = params
    B = p.attack_buffsize
    N = x.shape[-1]

    # delay line: out_sample[n] = x[n - B]  (negative index -> carried ring)
    full = jnp.concatenate([st.ring, x], axis=-1)              # (..., B+N)
    abs_x = jnp.abs(x)  # pmode=1 sqrt magnitude (DSP_Fn.cpp:516-519)
    abs_full = jnp.concatenate([st.abs_ring, abs_x], axis=-1)  # (..., B+N)
    delayed = full[..., :N]
    abs_out = abs_full[..., :N]
    new_ring = full[..., N:]
    new_abs_ring = abs_full[..., N:]

    # ring_max[n] = max(|x[n-B+1 .. n]|): window of width B ending at n,
    # i.e. sliding max of abs_full starting at offset n+1
    ring_max = _sliding_window_max(abs_full, B)[..., 1: 1 + N]

    # time-major inputs for the sample loop
    rm_t = jnp.moveaxis(ring_max, -1, 0)
    ao_t = jnp.moveaxis(abs_out, -1, 0)

    carry0 = (st.volts, st.save_volts, st.fast_backaverage,
              st.hang_backaverage, st.hang_counter, st.decay_type, st.state)
    if kernel is None:
        def step(s, inp):
            rm, ao = inp
            ns = agc_step(p, s, rm, ao)
            return ns, ns[0]

        final, volts_seq = jax.lax.scan(step, carry0, (rm_t, ao_t),
                                        unroll=8)
        mult = gain_curve(p, jnp.moveaxis(volts_seq, 0, -1))
    elif kernel in ("triton", "interpret"):
        from t41x.kernels.agc_triton import agc_gain
        final, mult_t = agc_gain(p, carry0, rm_t, ao_t,
                                 interpret=kernel == "interpret")
        mult = jnp.moveaxis(mult_t, 0, -1)
    else:
        raise ValueError(f"unknown AGC kernel {kernel!r}")
    y = delayed * mult.astype(delayed.dtype)
    return AGCState(new_ring, new_abs_ring, *final), y


def gain_curve(p: AGCParams, volts: jnp.ndarray) -> jnp.ndarray:
    """Log-domain gain from the AGC level (`DSP_Fn.cpp:623-627`); the
    Triton kernel applies the same function in-kernel."""
    return (p.out_target - p.slope_constant
            * jnp.minimum(0.0, jnp.log10(p.inv_max_input * volts))) / volts
