"""Time-sharded chain execution (JAX).

Completes the sequence-parallel story (SURVEY.md §7 phase 6): the RX
chain's LTI front end — RF gain, DC-block biquad, IQ correction, Fs/4
shift, NCO mix, x4+x2 decimation — is time-shardable because every
carried state is either a finite filter history, exchanged via one
`ppermute` per stage (t41x.mesh.halo), or an affine IIR state,
composed exactly across shards from one tiny `all_gather` (the DC-block
biquad: each shard runs zero-state, the per-shard final states compose
by a linear n_shards-step recurrence, and the zero-input response is
added back as one rank-2 correction).

The nonlinear tail (AGC state machine `DSP_Fn.cpp:479-632`, SAM PLL
`Demod.cpp:19-23`, NR trackers `Noise.cpp:19-32`) has an unbounded
per-sample dependency and cannot be halo-sharded; for offline captures
it runs as a SECOND PASS over the audio-rate output of the sharded
front end — 8x fewer samples — reusing the streamed chain's own
post-decimation code path (`RxChain._post_frontend`) verbatim, so the
two-pass result matches the streamed chain by construction.

Two entry points:

* `run_time_sharded(chain, mesh, iq)` — front-end only (legacy): Fs/4 +
  NCO + decimate + overlap-save band-pass, phase-coherent across shards.
* `run_time_sharded_full(chain, mesh, iq, params)` — the FULL chain:
  sharded front end (192 kHz work split over the `t` axis) + sequential
  nonlinear tail (24 kHz), same outputs dict as `RxChain.run`.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from t41x import constants as C
from t41x.mesh import halo


def sharded_frontend(chain, axis_name: str = "t", nco_freq: float = 0.0):
    """Per-shard function: (iq_seg, seg_index, n_shards) are implied by
    the mesh; iq_seg (..., N_seg) with N_seg divisible by BLOCK."""
    h1 = jnp.asarray(chain.h1)
    h2 = jnp.asarray(chain.h2)
    mask = jnp.asarray(chain.mask)

    def fn(seg):
        from t41x.dsp import nco

        n = seg.shape[-1]
        # global sample offset of this shard for phase-coherent shifts
        idx = jax.lax.axis_index(axis_name)
        offset = idx * n
        # Fs/4 shift with global phase: j^(offset+n) pattern
        k = jnp.arange(n) + offset
        pattern = jnp.exp(0.5j * jnp.pi * (k % 4)).astype(jnp.complex64)
        x = seg * pattern
        # NCO with global phase
        w = nco.nco_phase_inc(jnp.float32(nco_freq), chain.spec.sample_rate)
        theta = w * (k + 1).astype(jnp.float32)
        x = (nco.FREQ_ADJ_FACTOR * x) * jnp.exp(-1j * theta).astype(
            jnp.complex64)
        x = halo.sharded_fir_decimate(x, h1, C.DF1, axis_name)
        x = halo.sharded_fir_decimate(x, h2, C.DF2, axis_name)
        x = x * chain.vol_scale
        return halo.sharded_os_filter(x, mask, axis_name,
                                      chain.spec.fft_length)

    return fn


def run_time_sharded(chain, mesh: Mesh, iq, axis_name: str = "t",
                     nco_freq: float = 0.0):
    """Convenience: run the front end over a capture time-sharded on
    `mesh`.  iq: (N,) complex with N divisible by (n_devices * BLOCK)."""
    fn = sharded_frontend(chain, axis_name, nco_freq)
    sharded = jax.jit(jax.shard_map(
        fn, mesh=mesh, in_specs=P(axis_name), out_specs=P(axis_name)))
    return sharded(iq)


# ----------------------------------------------------------------------
# Full-chain time sharding (sharded LTI front end + sequential tail)
# ----------------------------------------------------------------------

def _dc_affine_terms(b: np.ndarray, a: np.ndarray, n_seg: int):
    """Zero-input operators for one biquad stage over an n_seg-sample
    segment, float64 at trace time:

      R  (n_seg, 2): y_zi[n] = s0 · R[n]   (R[n] = Cn @ An^n)
      AN (2, 2):     s_final = s0 @ AN.T + s_zero-state  (AN = An^n_seg)

    in the SAME balanced normal-form realization as
    `iir.BiquadChunked` (iir._normal_form_powers) — s0 here is a
    BiquadChunked state, so the coordinates must match, and the
    rotation form keeps An^n well-conditioned where the companion
    form's long powers peak at ~|1/(1-r)| entries for near-unity
    poles."""
    from t41x.dsp.iir import _normal_form_powers

    b0, b1, b2 = (float(b[0]), float(b[1]), float(b[2]))
    a1, a2 = float(a[1]), float(a[2])
    k = np.array([b1 - a1 * b0, b2 - a2 * b0])
    A = np.array([[-a1, 1.0], [-a2, 0.0]], np.float64)
    P = np.empty((n_seg + 1, 2, 2))
    P[0] = np.eye(2)
    for m in range(n_seg):           # companion fallback basis only
        P[m + 1] = A @ P[m]
    pw, Bn, Cn = _normal_form_powers(a1, a2, k, n_seg, P)
    R = np.einsum("j,njk->nk", Cn, pw[:n_seg])
    return R.astype(np.float32), pw[n_seg].astype(np.float32)


def sharded_frontend_full(chain, axis_name: str = "t",
                          vary_axes: tuple[str, ...] | None = None):
    """Per-shard FULL front end for `shard_map` over a `t` mesh axis:
    RF gain, DC-block biquad (exact via affine state composition), IQ
    correction, Fs/4 + NCO with globally coherent phase, x4+x2 halo
    decimation.  fn(seg, fe_params) with seg (..., N_seg) complex at the
    RF rate and fe_params = (gain, iq_amp, iq_phase, nco_freq) channel
    arrays (sharded over the channel mesh axis when there is one) ->
    (..., N_seg/8) complex at the audio rate, matching the streamed
    chain's pre-`_post_frontend` signal.
    """
    from t41x.chain import rx as rx_mod
    from t41x.dsp import nco

    spec = chain.spec
    h1 = jnp.asarray(chain.h1)
    h2 = jnp.asarray(chain.h2)
    vary = vary_axes if vary_axes is not None else (axis_name,)

    def fn(seg, fe_params):
        g, iq_amp, iq_phase, nco_freq = fe_params
        n = seg.shape[-1]
        assert n % (4 * C.DF) == 0, n
        R, AN = _dc_affine_terms(chain.dc_b[0], chain.dc_a[0], n)
        idx = jax.lax.axis_index(axis_name)
        offset = idx * n

        # RF gain (Process.cpp:117-134)
        x = seg * g[..., None]

        # DC-block biquad, exact across shards: zero-state local run +
        # affine composition of the tiny (2,) per-stage states
        xi = jnp.stack([x.real, x.imag], axis=-2)          # (..., 2, N)
        # mark the constant zero state as device-varying so shard_map's
        # vma typing accepts it as a scan carry alongside varying data
        zeros_st = jax.lax.pcast(
            jnp.zeros(xi.shape[:-1] + (1, 2), xi.dtype), vary,
            to="varying")
        st_z, y_z = chain.dc_op.apply(zeros_st, xi)
        z_all = jax.lax.all_gather(st_z, axis_name)        # (S, ..., 2, 1, 2)
        AN_j = jnp.asarray(AN)

        def comp(s, z):
            # emits the init state BEFORE shard j; carries init AFTER it
            return jnp.matmul(s, AN_j.T) + z, s

        _, inits = jax.lax.scan(comp, jnp.zeros_like(st_z), z_all)
        s_own = jnp.take(inits, idx, axis=0)               # (..., 2, 1, 2)
        y = y_z + jnp.einsum("...d,nd->...n", s_own[..., 0, :],
                             jnp.asarray(R))

        x = rx_mod.iq_correction(y[..., 0, :], y[..., 1, :],
                                 iq_amp, iq_phase)

        # Fs/4 with global phase: j^(offset) rotates the local pattern
        base = jnp.tile(jnp.array([1, 1j, -1, -1j], jnp.complex64), n // 4)
        rot = jnp.array([1, 1j, -1, -1j], jnp.complex64)[offset % 4]
        x = x * (base * rot)

        # NCO with the global sample offset folded into the start phase
        w = nco.nco_phase_inc(jnp.asarray(nco_freq, jnp.float32),
                              spec.sample_rate)
        phase0 = jnp.mod(w * offset.astype(jnp.float32), 2.0 * jnp.pi)
        _, x = nco.nco_mix(phase0, x, jnp.asarray(nco_freq),
                           spec.sample_rate)

        x = halo.sharded_fir_decimate(x, h1, C.DF1, axis_name)
        return halo.sharded_fir_decimate(x, h2, C.DF2, axis_name)

    return fn


def run_time_sharded_full(chain, mesh: Mesh, iq, params=None,
                          axis_name: str = "t",
                          channel_axis: str | None = None):
    """Run the FULL RX chain over an offline capture, time-sharded.

    Pass 1 (sharded over `t`): the LTI front end — all the 192 kHz-rate
    work — with ppermute halos for the decimators and exact DC-block
    state composition.  Pass 2 (sequential scan): the nonlinear tail —
    overlap-save band-pass, WDSP AGC, demod (incl. the SAM PLL), NR,
    notch, CW detection, EQ, x8 interpolation — over the 8x-smaller
    audio-rate stream, running `RxChain._post_frontend` verbatim so the
    result matches the streamed chain.

    iq: (..., N) complex at the RF rate, N divisible by
    n_shards * BLOCK_SIZE; leading dims are channels.  With
    `channel_axis` set (a second mesh axis name), the LEADING channel
    dim is additionally sharded over that axis — the full ch x t mesh —
    and per-channel params ride the same sharding.
    Returns the same outputs dict as `RxChain.run` (display zoom taps are
    unavailable: configure `spectrum_zoom=-1`).
    """
    from t41x.chain import default_params

    assert chain.spec.spectrum_zoom < 0, \
        "display zoom taps are front-end-resident; use spectrum_zoom=-1"
    iq = jnp.asarray(iq)
    ch = iq.shape[:-1]
    if params is None:
        params = default_params(ch)
    params = jax.tree.map(np.asarray, params)
    n_t = mesh.shape[axis_name]
    n = iq.shape[-1]
    assert n % (n_t * C.BLOCK_SIZE) == 0, (n, n_t)

    p = params
    fe_params = ((10.0 ** (p.rf_gain_db / 20.0) * p.band_gain
                  ).astype(np.float32),
                 np.asarray(p.iq_amp, np.float32),
                 np.asarray(p.iq_phase, np.float32),
                 np.asarray(p.nco_freq, np.float32))

    ch_specs = [None] * len(ch)
    if channel_axis is not None:
        assert ch, "channel_axis needs a channel batch dim"
        ch_specs[0] = channel_axis
        vary = (channel_axis, axis_name)
    else:
        vary = (axis_name,)
    fe = sharded_frontend_full(chain, axis_name, vary_axes=vary)
    seg_spec = P(*ch_specs, axis_name)
    par_spec = jax.tree.map(lambda _: P(*ch_specs), fe_params)
    fe_sh = jax.jit(jax.shard_map(fe, mesh=mesh,
                                  in_specs=(seg_spec, par_spec),
                                  out_specs=seg_spec))
    x24 = fe_sh(iq, fe_params)                      # (..., N/8) audio rate

    blk = C.BLOCK_SIZE // C.DF
    nb = x24.shape[-1] // blk
    blocks = jnp.moveaxis(x24.reshape(ch + (nb, blk)), -2, 0)

    def scan_tail(blocks, params):
        def step(st, xb):
            # front-end state fields pass through unchanged: the LTI
            # front end already ran in the sharded pass
            st, outs = chain._post_frontend(params, st, xb, {}, {})
            return st, outs

        st = chain.init_state(blocks.shape[1:-1])
        return jax.lax.scan(step, st, blocks)[1]

    if channel_axis is not None:
        # the tail rides the channel axis: every device runs the tail of
        # its own channels (kernels included), communication-free
        scan_tail = jax.shard_map(
            scan_tail, mesh=mesh,
            in_specs=(P(None, channel_axis), P(channel_axis)),
            out_specs=P(None, channel_axis), check_vma=False)
    outs = jax.jit(scan_tail)(blocks, params)

    def flatten(leaf):
        if leaf.ndim == len(ch) + 2:
            return jnp.moveaxis(leaf, 0, -2).reshape(ch + (-1,))
        return jnp.moveaxis(leaf, 0, -1)

    return {k: flatten(v) for k, v in outs.items()}
