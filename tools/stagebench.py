"""Per-stage / per-variant timing of the RX chain on the live device.

Times several ChainSpec variants (full chain, AGC off, NR on, FFT vs
matmul OS filter, ...) at a fixed channel count with the same
compute-bound methodology as bench.py (in-graph fori_loop repeats,
device-resident inputs, result fetch), and prints per-block µs per
variant so the cost of each stage is the delta between variants.

Usage: python tools/stagebench.py [--channels 1024] [--min-ms 150]
"""

from __future__ import annotations

import argparse
import sys
import time


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--channels", type=int, default=1024)
    ap.add_argument("--blocks", type=int, default=8)
    ap.add_argument("--min-ms", type=float, default=150.0)
    ap.add_argument("--variants", default="")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import numpy as np

    sys.path.insert(0, ".")
    from t41x import constants as C
    from t41x.chain import ChainSpec, RxChain, default_params

    from t41x.kernels import agc_kernel_for
    from t41x.utils import compile_cache

    compile_cache.enable()
    kernel = agc_kernel_for(jax.default_backend())
    variants = {
        "full": dict(),
        "agc_scan": dict(agc_kernel=None),
        "agc_off": dict(agc_mode=0),
        "fft_osfilter": dict(use_matmul_osfilter=False),
        "no_spectrum_taps": dict(spectrum_taps=False),
        "no_interp": dict(interpolate_out=False),
        "front_end_only": dict(mode="psk31", interpolate_out=False),
        "nr_spectral": dict(nr_mode=2),
        "nr_spectral_batch": dict(nr_mode=2, _batched=True),
        "nr_kim": dict(nr_mode=1),
        "nr_lms": dict(nr_mode=3),
        "notch": dict(notch_on=True),
        "eq": dict(eq_on=True),
        "sam": dict(mode="sam"),
        "nfm": dict(mode="nfm"),
        "cw": dict(mode="cw"),
        "q15": dict(q15_input=True),
        "zoom1": dict(spectrum_zoom=0),
        "zoom2": dict(spectrum_zoom=1),
        "zoom8": dict(spectrum_zoom=3),
        "zoom128": dict(spectrum_zoom=7),
    }
    if args.variants:
        keep = args.variants.split(",")
        variants = {k: v for k, v in variants.items() if k in keep}

    n_ch = args.channels
    rng = np.random.default_rng(0)
    iq = (rng.standard_normal((args.blocks, n_ch, C.BLOCK_SIZE))
          + 1j * rng.standard_normal((args.blocks, n_ch, C.BLOCK_SIZE))
          ).astype(np.complex64) * 0.1

    def floor() -> float:
        f = jax.jit(lambda v: v + 1.0)
        v = jnp.zeros((), jnp.float32)
        jax.block_until_ready(f(v))
        return min(_t_one(lambda: jax.block_until_ready(f(v)))
                   for _ in range(8))

    def _t_one(fn):
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0

    floor_s = floor()
    print(f"# dispatch floor {floor_s*1e3:.1f} ms", file=sys.stderr)

    base_us = None
    for name, kw in variants.items():
        kw = dict(kw)
        batched = kw.pop("_batched", False)
        spec = ChainSpec(**{**dict(interpolate_out=True,
                                   agc_kernel=kernel), **kw})
        chain = RxChain(spec)
        params = default_params((n_ch,))

        def mk(repeats):
            def chk(out):
                # checksum EVERY output so XLA cannot DCE any tap from
                # the timed region (summing audio alone silently
                # dropped the zoom/display/S-meter/interp outputs —
                # ~60 us/block of real production work; r5 finding,
                # reconciling the old bench-vs-stagebench delta)
                e = jnp.sum(out["audio_24k"] ** 2)
                for v in out.values():
                    if jnp.iscomplexobj(v):
                        v = v.real
                    e = e + jnp.sum(v.astype(jnp.float32)) \
                        * jnp.float32(1e-6)
                return e

            def body(blocks, st, params):
                def step(st, blk):
                    st, out = chain.block(params, st, blk)
                    return st, chk(out)

                def rep(_, acc):
                    st, e = acc
                    if batched:
                        st, outs = chain.block_batch(params, st, blocks)
                        return st, e + chk(outs)
                    st, ei = jax.lax.scan(step, st, blocks)
                    return st, e + jnp.sum(ei)

                st, e = jax.lax.fori_loop(0, repeats, rep,
                                          (st, jnp.float32(0.0)))
                return e

            run = jax.jit(body)
            if spec.q15_input:
                blocks = (
                    np.clip(np.round(iq.real * 32768.0), -32768,
                            32767).astype(np.int16),
                    np.clip(np.round(iq.imag * 32768.0), -32768,
                            32767).astype(np.int16))
            else:
                blocks = iq
            st = chain.init_state((n_ch,))
            blocks, st, p = jax.device_put((blocks, st, params))
            jax.block_until_ready((blocks, st, p))
            return run, blocks, st, p

        try:
            def go():
                jax.block_until_ready(run(blocks, st, p))

            run, blocks, st, p = mk(1)
            go()
            t1 = min(_t_one(go) for _ in range(2))
            per = max(t1 - floor_s, t1 / 10, 1e-5)
            repeats = max(1, int(np.ceil(args.min_ms / 1e3 / per)))
            if repeats > 1:
                run, blocks, st, p = mk(repeats)
                go()
            t = min(_t_one(go) for _ in range(3))
            n_blk = repeats * args.blocks
            us_blk = (t - floor_s) / n_blk * 1e6
            rate = n_blk * n_ch * C.BLOCK_SIZE / (t - floor_s)
            delta = "" if base_us is None else f"  (vs base {us_blk-base_us:+.0f} us)"
            if base_us is None:
                base_us = us_blk
            print(f"{name:28s} {us_blk:8.1f} us/block/{n_ch}ch  "
                  f"{rate/1e9:7.2f} Gs/s{delta}")
        except Exception as e:
            print(f"{name:28s} FAILED: {type(e).__name__}: {e}")


if __name__ == "__main__":
    main()
