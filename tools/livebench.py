"""Live pacing with the device in the loop (VERDICT r3 item 7).

The reference's one true performance metric is real-time load on the
processing hardware (`InfoBox.cpp:341-371`): mean block-processing time
over the 10.667 ms budget, with the audio queues absorbing jitter
(`Process.cpp:93-153`).  This tool measures the same thing for t41x
against the REAL backend: a pacing thread pushes channel-batched I/Q
blocks into the ring at rate_factor x real time (the acquisition-
interrupt analog), and the runner drains it with `step_batch` —
batch_blocks blocks per device dispatch (B blocks share one launch and
get B x 10.667 ms of budget for it).

Reports sustained load %, dispatch-time percentiles, ring backlog,
end-to-end latency (input-block arrival -> audio ready), and overruns.

    python tools/livebench.py --channels 64 --batch-blocks 1 --seconds 10
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
import time


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--channels", type=int, default=64)
    ap.add_argument("--batch-blocks", type=int, default=1)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--rate-factor", type=float, default=1.0)
    ap.add_argument("--mode", default="usb")
    ap.add_argument("--zoom", type=int, default=1,
                    help="spectrum zoom (display tap ON, like the "
                         "reference's always-on panadapter)")
    ap.add_argument("--ring-capacity", type=int, default=192,
                    help="ring depth in blocks (absorbs dispatch jitter)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import numpy as np

    sys.path.insert(0, ".")
    from t41x import constants as C
    from t41x.radio import Radio
    from t41x.runner import StreamRunner
    from t41x.utils import compile_cache

    compile_cache.enable()

    ch = (args.channels,) if args.channels > 1 else ()
    radio = Radio()
    radio.config.band.mode = args.mode
    radio.config.spectrum_zoom = args.zoom

    from t41x.io.runtime import BlockRing

    n_floats = 2 * C.BLOCK_SIZE
    for d in ch:
        n_floats *= d
    ring = BlockRing(block_floats=n_floats, capacity=args.ring_capacity)
    runner = StreamRunner(radio, ring=ring, channels=ch,
                          batch_blocks=args.batch_blocks)
    t0 = time.perf_counter()
    runner.prime()
    compile_s = time.perf_counter() - t0
    print(f"# primed in {compile_s:.1f} s "
          f"(backend {__import__('jax').default_backend()})",
          file=sys.stderr)

    # a short unique capture, cycled by the pacing thread
    rng = np.random.default_rng(0)
    n_uniq = 16
    cap = (rng.standard_normal((n_uniq,) + ch + (C.BLOCK_SIZE,))
           + 1j * rng.standard_normal((n_uniq,) + ch + (C.BLOCK_SIZE,))
           ).astype(np.complex64) * 0.1
    flat = [np.ascontiguousarray(cap[i]).view(np.float32).reshape(-1)
            for i in range(n_uniq)]

    # warmup dispatches: the first live calls otherwise pay the
    # host->device transfer of the whole state pytree inside the paced
    # window
    for i in range(2 * args.batch_blocks):
        runner.ring.push(flat[i % n_uniq])
    t0 = time.perf_counter()
    while runner.ring.available() >= args.batch_blocks:
        runner.step_batch()
    print(f"# warmup dispatches in {time.perf_counter() - t0:.1f} s",
          file=sys.stderr)
    from t41x.io.runtime import LoadMeter
    runner.load = LoadMeter(force_python=True)
    runner.blocks_processed = 0

    n_blocks = int(args.seconds / C.BLOCK_SECONDS)
    push_times: list[float] = []
    stop = threading.Event()

    def pace():
        nxt = time.monotonic()
        per = C.BLOCK_SECONDS / args.rate_factor
        for i in range(n_blocks):
            if stop.is_set():
                break
            nxt += per
            dt = nxt - time.monotonic()
            if dt > 0:
                time.sleep(dt)
            runner.ring.push(flat[i % n_uniq])
            push_times.append(time.perf_counter())

    th = threading.Thread(target=pace, daemon=True)
    start = time.perf_counter()
    th.start()

    dispatch_walls: list[float] = []
    depths: list[int] = []
    done_times: list[float] = []
    processed = 0
    deadline = start + args.seconds / args.rate_factor + 10.0
    while processed < n_blocks and time.perf_counter() < deadline:
        depths.append(runner.ring.available())
        t1 = time.perf_counter()
        r = runner.step_batch()
        if r is None:
            time.sleep(0.001)
            continue
        dispatch_walls.append(time.perf_counter() - t1)
        done_times.append(time.perf_counter())
        processed = runner.blocks_processed
    stop.set()
    th.join(timeout=5.0)

    # end-to-end latency: for each batch, audio-ready time minus the
    # arrival time of the batch's FIRST block
    lat = []
    for bi, tdone in enumerate(done_times):
        first_block = bi * args.batch_blocks
        if first_block < len(push_times):
            lat.append(tdone - push_times[first_block])
    walls = np.asarray(dispatch_walls)
    lat = np.asarray(lat) if lat else np.asarray([float("nan")])
    budget = args.batch_blocks * C.BLOCK_SECONDS

    result = {
        "channels": args.channels,
        "batch_blocks": args.batch_blocks,
        "rate_factor": args.rate_factor,
        "mode": args.mode,
        "zoom": args.zoom,
        "blocks_pushed": len(push_times),
        "blocks_processed": processed,
        "ring_overruns": runner.ring.overruns,
        "load_percent": runner.load.percent,
        "dispatch_ms_p50": float(np.percentile(walls, 50) * 1e3),
        "dispatch_ms_p95": float(np.percentile(walls, 95) * 1e3),
        "dispatch_budget_ms": budget * 1e3,
        "latency_ms_p50": float(np.nanpercentile(lat, 50) * 1e3),
        "latency_ms_p95": float(np.nanpercentile(lat, 95) * 1e3),
        "max_ring_depth": int(max(depths, default=0)),
        "compile_s": compile_s,
        "realtime_iq_samples_per_sec": args.channels * C.SAMPLE_RATE,
        "sustained": (processed >= len(push_times) - 2 * args.batch_blocks
                      and runner.ring.overruns == 0),
    }
    print(f"load {result['load_percent']:.1f}%  dispatch p50 "
          f"{result['dispatch_ms_p50']:.1f} / budget {budget*1e3:.1f} ms  "
          f"latency p50 {result['latency_ms_p50']:.0f} ms  "
          f"processed {processed}/{len(push_times)}  "
          f"overruns {result['ring_overruns']}  "
          f"sustained={result['sustained']}", file=sys.stderr)
    print("RESULT " + json.dumps(result))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
