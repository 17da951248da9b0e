"""Pallas kernel through Triton: the WDSP AGC gain recurrence.

The AGC's per-sample state machine (reference `DSP_Fn.cpp:479-632`;
`t41x/dsp/agc.py` has the functional derivation) is sequential in time:
the gain at sample n depends on the gain at n-1.  As a `lax.scan` each
audio sample is a device while-loop iteration, and the fixed cost of an
iteration, not its ~40 flops, sets the stage's time.

This kernel runs a whole block's recurrence in one launch.  Each
program owns a tile of channels and keeps the seven per-channel state
words in registers for the whole block while an in-kernel `fori_loop`
walks the samples.  It reads the time-major (N, C) ring-max and |x|
streams, so each step's row is contiguous across the tile's channels
(coalesced loads that do not depend on the carry), and writes the
per-sample gain `mult` (N, C) plus the final state.

The parallel prework (|x|, the look-ahead delay line, the sliding-window
max and the final delayed multiply) stays in XLA, where it fuses; see
`t41x.dsp.agc.agc_apply`.  The step math is `t41x.dsp.agc.agc_step`,
pinned by the scalar oracle (`tests/test_agc_oracle.py`).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from t41x.dsp.agc import agc_step, gain_curve

# H100 SXM streaming multiprocessors: channel tiles are sized so that a
# 1024-channel batch already spreads over (nearly) all of them
_SMS = 132
_MAX_TILE = 128


def tile_channels(c: int) -> int:
    """Channels per program: the power of two that puts about one
    program on each SM, at most `_MAX_TILE` (4 warps)."""
    want = -(-c // _SMS)
    return min(_MAX_TILE, pl.next_power_of_2(max(want, 1)))


def _kernel(p, n, rm_ref, ao_ref, *refs):
    state_in, (mult_ref, *state_out) = refs[:7], refs[7:]

    def body(t, c):
        carry, rm, ao = c
        # issue the next row's loads before this step's dependent chain,
        # so their latency hides behind it
        nxt = jnp.minimum(t + 1, n - 1)
        rm_next, ao_next = rm_ref[nxt], ao_ref[nxt]
        new = agc_step(p, carry, rm, ao)
        mult_ref[t] = gain_curve(p, new[0])
        return new, rm_next, ao_next

    init = (tuple(r[...] for r in state_in), rm_ref[0], ao_ref[0])
    final = jax.lax.fori_loop(0, n, body, init)[0]
    for ref, v in zip(state_out, final):
        ref[...] = v


@functools.partial(jax.jit, static_argnums=(0, 4, 5))
def _call(p, rm, ao, states, tile, interpret):
    """rm/ao: (N, Cp) time-major; states: 4x f32 + 3x i32 (Cp,); Cp is a
    multiple of `tile`.  Grid over channel tiles."""
    n, cp = rm.shape
    by_time = pl.BlockSpec((n, tile), lambda i: (0, i))
    by_chan = pl.BlockSpec((tile,), lambda i: (i,))
    return pl.pallas_call(
        functools.partial(_kernel, p, n),
        grid=(cp // tile,),
        in_specs=[by_time, by_time] + [by_chan] * 7,
        out_specs=[by_time] + [by_chan] * 7,
        out_shape=[jax.ShapeDtypeStruct((n, cp), jnp.float32)]
        + [jax.ShapeDtypeStruct((cp,), s.dtype) for s in states],
        compiler_params=pl_triton.CompilerParams(
            num_warps=max(1, tile // 32), num_stages=2),
        interpret=interpret,
        name="agc_gain",
    )(rm, ao, *states)


def agc_gain(p, carry0, rm_t, ao_t, *, interpret: bool = False):
    """The AGC recurrence plus gain curve for one block.

    carry0: 7-tuple of (...,) channel-shaped state arrays (volts,
    save_volts, fast/hang back-averages as float32; hang_counter,
    decay_type, state as int32).  rm_t/ao_t: (N, ...) time-major
    ring-max and delayed |x| streams.  Returns (final carry, mult) with
    mult (N, ...) the per-sample gain.  `interpret=True` runs the same
    kernel in the Pallas interpreter (CPU tests)."""
    n = rm_t.shape[0]
    ch_shape = rm_t.shape[1:]
    c = 1
    for d in ch_shape:
        c *= d
    tile = tile_channels(c)
    pad = -c % tile

    def prep(a, dtype, time_major):
        a = jnp.asarray(a, dtype).reshape((n, c) if time_major else (c,))
        widths = ((0, 0), (0, pad)) if time_major else ((0, pad),)
        return jnp.pad(a, widths) if pad else a

    rm = prep(rm_t, jnp.float32, True)
    ao = prep(ao_t, jnp.float32, True)
    states = tuple(prep(s, jnp.float32, False) for s in carry0[:4]) + \
        tuple(prep(s, jnp.int32, False) for s in carry0[4:])
    mult, *finals = _call(p, rm, ao, states, tile, interpret)
    mult = mult[:, :c].reshape((n,) + ch_shape)
    return tuple(f[:c].reshape(ch_shape) for f in finals), mult
