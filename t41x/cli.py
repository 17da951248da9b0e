"""t41x command-line interface.

    python -m t41x.cli rx    --in cap.wav --mode usb --out audio.wav
    python -m t41x.cli ft8   --in cap.wav
    python -m t41x.cli cw    --in cap.wav
    python -m t41x.cli psk31 --in cap.wav --tone 1000
    python -m t41x.cli info

Captures are stereo WAV files (L=I, R=Q) at 192 kHz.  Config persists to
--config (JSON, the EEPROM/SD analog).
"""

from __future__ import annotations

import argparse
import json
import sys


def _ft8_line(d) -> str:
    """One decode line like the reference's message display
    (`ft8.cpp:900-905`: SNR, distance, message)."""
    dist = f"{d.distance_km:6.0f} km" if d.distance_km is not None \
        else "      - "
    return (f"{d.freq_hz:7.1f} Hz  {d.snr_db:+5.1f} dB  {dist}  "
            f"{d.text}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="t41x")
    ap.add_argument("--config", default=None,
                    help="JSON config path (persisted)")
    sub = ap.add_subparsers(dest="cmd", required=True)

    rx = sub.add_parser("rx", help="demodulate a capture to audio")
    rx.add_argument("--in", dest="inp", required=True)
    rx.add_argument("--out", default=None, help="output audio WAV")
    rx.add_argument("--mode", default=None,
                    choices=["usb", "lsb", "am", "sam", "nfm", "cw"])
    rx.add_argument("--nco", type=float, default=None)
    rx.add_argument("--flo", type=float, default=None)
    rx.add_argument("--fhi", type=float, default=None)
    rx.add_argument("--agc", type=int, default=None)
    rx.add_argument("--nr", type=int, default=None)
    rx.add_argument("--panadapter", default=None, metavar="PNG",
                    help="render spectrum+waterfall of the capture")
    rx.add_argument("--ascii-spectrum", action="store_true",
                    help="print a terminal spectrum of the capture")

    for name in ("ft8", "cw", "psk31"):
        p = sub.add_parser(name, help=f"decode {name} from a capture")
        p.add_argument("--in", dest="inp", required=True)
        p.add_argument("--nco", type=float, default=None)
        if name == "psk31":
            p.add_argument("--tone", type=float, default=1000.0)

    sub.add_parser("info", help="print configuration")

    op = sub.add_parser("operate",
                        help="live operator session over a capture stream "
                             "(tune/band/mode + ASCII panadapter)")
    op.add_argument("--in", dest="inp", required=True)
    op.add_argument("--rate-factor", type=float, default=1.0,
                    help="stream pacing vs real time (0 = flat out)")
    op.add_argument("--serve", type=int, default=None, metavar="PORT",
                    help="also serve the session on this TCP port")

    args = ap.parse_args(argv)

    from t41x.utils import compile_cache

    compile_cache.enable()

    from t41x.config import RadioConfig
    from t41x.radio import Radio

    cfg = RadioConfig.load(args.config) if args.config else RadioConfig()
    radio = Radio(cfg)

    if args.cmd == "info":
        print(json.dumps(cfg.to_dict(), indent=2))
        return 0

    from t41x.io import wav

    import numpy as np

    if args.cmd == "operate":
        import threading
        import time

        from t41x.io import repl as repl_mod
        from t41x.io.runtime import CaptureStreamer
        from t41x.runner import StreamRunner

        iq, rate = wav.read_iq_wav(args.inp)
        runner = StreamRunner(radio)
        runner.prime()
        streamer = CaptureStreamer(runner.ring, iq,
                                   rate_factor=args.rate_factor)
        stop = threading.Event()

        def pump():
            while not stop.is_set():
                if runner.step() is None:
                    time.sleep(0.002)

        pump_thread = threading.Thread(target=pump)
        pump_thread.start()
        # let the first blocks land so spectrum/status have data
        t0 = time.monotonic()
        while runner.blocks_processed == 0 and time.monotonic() - t0 < 3.0:
            time.sleep(0.01)
        srv = repl_mod.OperatorServer(runner, port=args.serve) \
            if args.serve else None
        if srv:
            print(f"operator session on tcp port {srv.port}")
        try:
            repl_mod.interactive(runner)
        finally:
            stop.set()
            pump_thread.join(timeout=10)
            streamer.stop()
            if srv:
                srv.close()
        if args.config:
            cfg.save(args.config)
        return 0

    if args.cmd == "ft8":
        # the reference's WAV test mode plays mono audio recordings
        # (DEMOD_FT8_WAV, Process.cpp:278-374); accept those directly
        data, rate = wav.read_wav(args.inp)
        if data.ndim == 1:
            if rate != 24000:  # linear-resample to the audio rate
                t_out = np.arange(int(len(data) * 24000 / rate)) / 24000
                data = np.interp(t_out, np.arange(len(data)) / rate,
                                 data).astype(np.float32)
            from t41x.decode.ft8 import decode as ft8dec
            for d in ft8dec.decode_audio(data, my_grid=cfg.my_grid):
                print(_ft8_line(d))
            if args.config:
                cfg.save(args.config)
            return 0
        iq = (data[:, 0] + 1j * data[:, 1]).astype(np.complex64)
    else:
        iq, rate = wav.read_iq_wav(args.inp)
    if getattr(args, "nco", None) is not None:
        radio.set_fine_tune(args.nco)

    if args.cmd == "rx":
        if args.mode:
            radio.set_mode(args.mode)
        if args.flo is not None or args.fhi is not None:
            radio.set_filter(args.flo if args.flo is not None
                             else cfg.band.f_lo_cut,
                             args.fhi if args.fhi is not None
                             else cfg.band.f_hi_cut)
        if args.agc is not None:
            radio.set_agc(args.agc)
        if args.nr is not None:
            radio.set_nr(args.nr)
        out = radio.receive(iq)
        audio = out["audio_24k"]
        peak = float(abs(audio).max() or 1.0)
        if args.out:
            wav.write_wav(args.out, audio / (1.05 * peak), 24000)
            print(f"wrote {args.out}: {audio.shape[-1]} samples @24 kHz")
        m = radio.metrics
        print(f"processed {m['input_samples']} samples in "
              f"{m['wall_s']:.2f} s ({m['realtime_channels']:.1f}x realtime)")
        if (args.panadapter or args.ascii_spectrum) \
                and "rf_spectrum" in out:
            from t41x.io import display
            spec_blocks = out["rf_spectrum"]
            spec_blocks = spec_blocks.reshape(-1, display.SPECTRUM_RES)
            spec_db = 10.0 * np.log10(np.maximum(spec_blocks, 1e-30))
            spec_db -= np.median(spec_db[-1])   # noise floor at 0 dB
            if args.panadapter:
                img = display.render_panadapter(
                    spec_db[-1], spec_db[::-1],
                    f_lo=cfg.band.f_lo_cut, f_hi=cfg.band.f_hi_cut,
                    span_hz=192_000 / (1 << max(cfg.spectrum_zoom, 0)))
                display.save_png(args.panadapter, img)
                print(f"wrote {args.panadapter}: {img.shape[1]}x"
                      f"{img.shape[0]} panadapter")
            if args.ascii_spectrum:
                print(display.ascii_spectrum(spec_db[-1]))
    elif args.cmd == "ft8":
        for d in radio.decode_ft8(iq):
            print(_ft8_line(d))
    elif args.cmd == "cw":
        print(radio.decode_cw(iq))
    elif args.cmd == "psk31":
        print(radio.decode_psk31(iq, tone_hz=args.tone))

    if args.config:
        cfg.save(args.config)
    return 0


if __name__ == "__main__":
    sys.exit(main())
