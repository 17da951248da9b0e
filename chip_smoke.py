"""Smoke run of the receive chain on one NVIDIA GPU.

Drives the main path once through the entry points a user calls, at the
size users of a channelized receiver run, and checks each result on the
card against the repo's plain reference:

1. device — JAX's device must be a GPU; prints the card, the JAX
   version, the matmul precision, XLA_FLAGS and the compile cache;
2. kernels — the AGC Triton kernel vs the plain `lax.scan` AGC at 1024,
   4096 and 1000 channels over 16 blocks with the state carried (audio
   SNR >= 100 dB, integer state fields equal), and the flagship step's
   `memory_analysis()`;
3. chain — every `bench.py` configuration at 1024 channels over 16
   blocks: the production path vs the plain path at "highest" (audio
   >= 55 dB, displayed spectrum within 0.5 dB), and the plain chain at
   the production precision vs the same chain on this process's CPU
   device at 8 channels;
4. entry points — `Radio.receive` on 64 channels of planted USB tones,
   the CLI's rx/ft8/cw/psk31 commands on generated captures, and
   `StreamRunner` fed from the block ring at rate_factor 1;
5. the last line, one JSON object naming the device.

`--four-cards` runs only the multi-card phase on 4 GPUs: the flagship
chain channel-sharded at 4x1024 channels vs the same channels on one
card, and `timeshard.run_time_sharded_full` on a 2x2 (ch, t) mesh vs
the streamed chain.

    python chip_smoke.py [--four-cards]

Any failure exits non-zero without the last line.  One process drives
the card(s): JAX reserves most of a card's memory when it starts.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import jax
import numpy as np

T0 = time.perf_counter()
LOUD = 1.0


def log(msg: str) -> None:
    print(f"[{time.perf_counter() - T0:7.1f} s] {msg}", flush=True)


def phase_device(n_cards: int) -> None:
    from t41x.utils import compile_cache, gpu

    gpu.require_gpu()
    if len(jax.devices()) < n_cards:
        raise SystemExit(f"needs {n_cards} GPUs, JAX found "
                         f"{len(jax.devices())}")
    cache = compile_cache.enable()
    d = gpu.describe()
    log(f"device: {d['device_kind']} x{d['device_count']} "
        f"({d['platform']})")
    print(gpu.card_name_power(), flush=True)
    log(f"jax {jax.__version__}; matmul precision "
        f"{d['matmul_precision']}; XLA_FLAGS={d['xla_flags']!r}; "
        f"compile cache {cache}")


def agc_blocks(ch: int, n_blocks: int, seed: int = 0):
    """Complex audio-rate blocks whose level steps between loud and
    quiet stretches, so attack, hang and decay all run."""
    rng = np.random.default_rng(seed)
    level = np.where((np.arange(n_blocks) // 3) % 2, 0.02, LOUD)
    x = (rng.standard_normal((n_blocks, ch, 256))
         + 1j * rng.standard_normal((n_blocks, ch, 256)))
    return (x * level[:, None, None]).astype(np.complex64)


def agc_parity(ch: int, n_blocks: int = 16) -> dict:
    """The AGC kernel vs the plain scan over `n_blocks` carried blocks,
    both on the card; returns the audio SNR and the integer-state
    mismatch count."""
    from bench import snr_db
    from t41x.dsp import agc as A
    from t41x.kernels import agc_kernel_for

    p = A.agc_params(2)
    xs = agc_blocks(ch, n_blocks, seed=ch)

    def run(kernel):
        def body(st, x):
            return A.agc_apply(p, st, x, kernel=kernel)

        return jax.jit(lambda st, xs: jax.lax.scan(body, st, xs))(
            A.agc_state(p, (ch,)), xs)

    st_k, y_k = run(agc_kernel_for(jax.default_backend()))
    st_s, y_s = run(None)
    bad = sum(int(np.sum(np.asarray(getattr(st_k, f))
                         != np.asarray(getattr(st_s, f))))
              for f in ("hang_counter", "decay_type", "state"))
    return {"audio_db": snr_db(y_s, y_k), "int_state_mismatches": bad}


def phase_kernels(widths=(1024, 4096, 1000), n_ch: int = 1024) -> None:
    from t41x import constants as C
    from t41x.chain import RxChain, default_params

    for ch in widths:
        r = agc_parity(ch)
        log(f"agc kernel vs scan, {ch} ch x 16 blocks: {r}")
        if r["audio_db"] < 100.0 or r["int_state_mismatches"]:
            raise AssertionError(f"AGC kernel parity at {ch} ch: {r}")

    chain = RxChain(production_spec("rx"))
    step = jax.jit(chain.block).lower(
        default_params((n_ch,)), chain.init_state((n_ch,)),
        np.zeros((n_ch, C.BLOCK_SIZE), np.complex64)).compile()
    log(f"flagship step at {n_ch} ch, memory_analysis: "
        f"{step.memory_analysis()}")


def production_spec(config: str):
    """The spec `bench.py --config <config>` times on the card."""
    from bench import config_kwargs
    from t41x.chain import ChainSpec
    from t41x.kernels import agc_kernel_for

    return ChainSpec(spectrum_taps=True, use_matmul_osfilter=True,
                     interpolate_out=True,
                     agc_kernel=agc_kernel_for(jax.default_backend()),
                     **config_kwargs(config))


def phase_chain(n_ch: int = 1024, n_blocks: int = 16) -> dict:
    import dataclasses

    import bench

    prod = jax.config.jax_default_matmul_precision
    cpu = jax.devices("cpu")[0]
    table = {}
    for config in bench.CONFIGS:
        if config == "tx":
            mic = bench.tx_mic(n_ch, n_blocks)
            vs_plain = {"tx_iq": bench.snr_db(
                bench.stream_tx(mic, n_blocks, "highest"),
                bench.stream_tx(mic, n_blocks, prod))}
            mic8 = bench.tx_mic(8, n_blocks)
            vs_cpu = {"tx_iq": bench.snr_db(
                bench.stream_tx(mic8, n_blocks, prod, device=cpu),
                bench.stream_tx(mic8, n_blocks, prod))}
        else:
            spec = production_spec(config)
            plain = dataclasses.replace(spec, agc_kernel=None)
            # the channelizer row splits 16-channel wideband captures
            k = 16 if config == "channelizer" else None
            w = k or 1
            data = bench.planted_capture(n_ch // w, n_blocks * w)
            vs_plain = bench.compare_outputs(
                bench.stream_chain(plain, data, n_blocks, "highest",
                                   channelizer_k=k),
                bench.stream_chain(spec, data, n_blocks, prod,
                                   channelizer_k=k))
            d8 = bench.planted_capture(max(8 // w, 1), n_blocks * w, seed=3)
            vs_cpu = bench.compare_outputs(
                bench.stream_chain(plain, d8, n_blocks, prod, device=cpu,
                                   channelizer_k=k),
                bench.stream_chain(plain, d8, n_blocks, prod,
                                   channelizer_k=k))
        log(f"chain {config}: production vs plain@highest {vs_plain}; "
            f"plain@{prod} GPU vs CPU (8 ch) {vs_cpu}")
        bench.assert_parity(vs_plain, f"{config} vs plain@highest")
        bench.assert_parity(vs_cpu, f"{config} GPU vs CPU")
        table[config] = {"vs_plain_highest": vs_plain, "vs_cpu": vs_cpu}
    return table


def phase_entry_points(workdir: str) -> None:
    import contextlib
    import io
    import os

    from t41x import constants as C
    from t41x.cli import main as cli_main
    from t41x.io import signals, wav
    from t41x.radio import Radio

    # Radio.receive: 64 channels, one planted USB tone each
    n_ch, n = 64, 24 * C.BLOCK_SIZE
    freqs = 400.0 + 35.0 * np.arange(n_ch)
    iq = np.stack([signals.usb_signal([f], n) * 0.25 for f in freqs])
    radio = Radio()
    out = radio.receive(iq)
    snrs = [signals.tone_fit_snr(out["audio_24k"][c, 4096:], [freqs[c]],
                                 C.AUDIO_RATE) for c in range(n_ch)]
    log(f"Radio.receive {n_ch} ch (agc_kernel="
        f"{radio.chain.spec.agc_kernel}): tone SNR min {min(snrs):.1f} dB, "
        f"{radio.metrics['realtime_channels']:.0f}x real time "
        "(compile included)")
    if min(snrs) < 30.0:
        raise AssertionError(f"Radio.receive tone SNR {min(snrs)}")

    def cli(*argv) -> str:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli_main(list(argv))
        if rc != 0:
            raise AssertionError(f"cli {argv}: exit {rc}")
        return buf.getvalue()

    cap = os.path.join(workdir, "rx.wav")
    wav.write_iq_wav(cap, signals.usb_signal([700.0], n) * 0.25,
                     C.SAMPLE_RATE)
    audio_out = os.path.join(workdir, "audio.wav")
    cli("rx", "--in", cap, "--out", audio_out, "--mode", "usb")
    audio, rate = wav.read_wav(audio_out)
    snr = signals.tone_fit_snr(audio[4096:], [700.0], rate)
    log(f"cli rx: tone SNR {snr:.1f} dB")
    if snr < 25.0:
        raise AssertionError(f"cli rx tone SNR {snr}")

    from tests.fixtures import cw_gen, ft8_gen, psk31_gen

    msg = "CQ K1ABC FN42"
    tones = ft8_gen.tones(msg)
    sps = int(round(0.16 * C.SAMPLE_RATE))
    inst = -C.SAMPLE_RATE / 4 + 1200.0 + np.repeat(tones * 6.25, sps)
    pad = np.zeros(int(0.5 * C.SAMPLE_RATE))
    sig = 0.3 * np.exp(2j * np.pi * np.cumsum(inst) / C.SAMPLE_RATE)
    slot = np.concatenate([pad, sig, pad, pad])
    slot = slot[: len(slot) // C.BLOCK_SIZE * C.BLOCK_SIZE]
    cap = os.path.join(workdir, "ft8.wav")
    wav.write_iq_wav(cap, slot.astype(np.complex64), C.SAMPLE_RATE)
    got = cli("ft8", "--in", cap)
    log(f"cli ft8: {got.strip()!r}")
    if msg not in got:
        raise AssertionError(f"ft8 did not decode {msg!r}: {got!r}")

    text = "CQ TEST"
    iq = cw_gen.synth_iq(text, wpm=18.0)
    cap = os.path.join(workdir, "cw.wav")
    wav.write_iq_wav(cap, iq[: len(iq) // C.BLOCK_SIZE * C.BLOCK_SIZE],
                     C.SAMPLE_RATE)
    got = cli("cw", "--in", cap)
    log(f"cli cw: {got.strip()!r}")
    if text.replace(" ", "") not in got.replace(" ", ""):
        raise AssertionError(f"cw did not decode {text!r}: {got!r}")

    text = "CQ DE T41X"
    iq = psk31_gen.synth_iq(text, tone_hz=1000.0)
    cap = os.path.join(workdir, "psk.wav")
    wav.write_iq_wav(cap, iq[: len(iq) // C.BLOCK_SIZE * C.BLOCK_SIZE],
                     C.SAMPLE_RATE)
    got = cli("psk31", "--in", cap, "--tone", "1000")
    log(f"cli psk31: {got.strip()!r}")
    if text not in got:
        raise AssertionError(f"psk31 did not decode {text!r}: {got!r}")

    phase_runner()


def phase_runner(n_ch: int = 64, n_blocks: int = 300) -> None:
    from t41x import constants as C
    from t41x.io import signals
    from t41x.io.runtime import BlockRing, CaptureStreamer
    from t41x.radio import Radio
    from t41x.runner import StreamRunner

    radio = Radio()
    ring = BlockRing(block_floats=2 * C.BLOCK_SIZE * n_ch, capacity=64)
    runner = StreamRunner(radio, ring=ring, channels=(n_ch,))
    runner.prime()
    tone = signals.usb_signal([1000.0], n_blocks * C.BLOCK_SIZE) * 0.25
    iq = np.broadcast_to(tone.reshape(n_blocks, 1, C.BLOCK_SIZE),
                         (n_blocks, n_ch, C.BLOCK_SIZE))
    streamer = CaptureStreamer(ring, np.ascontiguousarray(iq),
                               rate_factor=1.0)
    # until the capture has been sent and the ring drained; blocks the
    # ring dropped (overruns) are reported, not retried
    t_end = time.monotonic() + 2 * n_blocks * C.BLOCK_SECONDS + 30.0
    while time.monotonic() < t_end:
        if runner.step() is None:
            if not streamer.running:
                break
            time.sleep(0.001)
    streamer.stop()
    log(f"StreamRunner {n_ch} ch, {runner.blocks_processed}/{n_blocks} "
        f"blocks at rate_factor 1: load {runner.load.percent:.1f}%, "
        f"ring overruns {ring.overruns}")
    if runner.blocks_processed == 0:
        raise AssertionError("StreamRunner processed no block")


def phase_four_cards(per_card: int = 1024, n_blocks: int = 16,
                     ts_channels: int = 256, ts_blocks: int = 64) -> None:
    import bench
    from jax.sharding import Mesh

    from t41x.chain import RxChain, default_params
    from t41x.mesh import sharding, timeshard

    devs = jax.devices()[:4]
    # flagship chain, channel-sharded: 4 x 1024 channels
    n_ch = 4 * per_card
    chain = RxChain(production_spec("rx"))
    iq = bench.planted_capture(n_ch, n_blocks)
    params = default_params((n_ch,))
    mesh = sharding.make_mesh(4, devices=devs)
    audio = sharding.channel_sharded_run(chain, mesh, params, iq, n_blocks)
    homes = {s.device: s.data.shape for s in audio.addressable_shards}
    log(f"channel-sharded audio shards: {homes}")
    if len(homes) != 4 or any(v[0] != per_card for v in homes.values()):
        raise AssertionError(f"shards not spread over 4 cards: {homes}")
    one = sharding.make_mesh(1, devices=devs[:1])
    ref = sharding.channel_sharded_run(chain, one, params, iq, n_blocks)
    db = bench.snr_db(np.asarray(ref), np.asarray(audio))
    log(f"4-card channel-sharded vs 1 card, {n_ch} ch x {n_blocks} "
        f"blocks: audio_24k {db} dB")
    if db < 80.0:
        raise AssertionError(f"channel-sharded parity {db} dB")

    # offline capture time-sharded over a 2 x 2 (ch, t) mesh
    import dataclasses

    spec = dataclasses.replace(production_spec("rx"), spectrum_zoom=-1)
    chain = RxChain(spec)
    n_ch, n_blocks = ts_channels, ts_blocks
    iq = bench.planted_capture(n_ch, n_blocks, seed=5)
    params = default_params((n_ch,), nco_freq=2500.0)
    mesh = Mesh(np.asarray(devs).reshape(2, 2), ("ch", "t"))
    got = timeshard.run_time_sharded_full(chain, mesh, iq, params,
                                          channel_axis="ch")
    ref = chain.run(iq, params=params)
    res = {k: bench.snr_db(ref[k], got[k]) for k in ("audio_24k", "audio")}
    log(f"2x2 (ch, t) time-sharded vs streamed, {n_ch} ch x {n_blocks} "
        f"blocks: {res}")
    if min(res.values()) < 55.0:
        raise AssertionError(f"time-sharded parity {res}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-GPU phase")
    args = ap.parse_args()

    n_cards = 4 if args.four_cards else 1
    phase_device(n_cards)
    if args.four_cards:
        phase_four_cards()
    else:
        import tempfile

        phase_kernels()
        phase_chain()
        with tempfile.TemporaryDirectory() as workdir:
            phase_entry_points(workdir)
    dev = jax.devices()[0]
    log("all phases passed")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
