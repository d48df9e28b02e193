"""Command line of the port: `listen`, `tui`, `decode` (single-carrier or
wideband), `downlink`, `uplink`, `scan`, `waterfall`, `codec`, `frames`
and `devices`.

    python -m tetraear_tpu_torch listen [--iq-file f | --synthetic]
        [-f MHz] [--no-afc] [--overlap N] [--max-chunks N] [-o out.jsonl]
        [--waterfall wf.ppm] [--trace-dir DIR] [--sdr-device SERIAL]
        [--device cuda|cpu] ...
    python -m tetraear_tpu_torch tui [--iq-file f | --synthetic]
        [--max-chunks N] [--duration S] [--device cuda|cpu] ...
    python -m tetraear_tpu_torch decode <iq>
        [--profile ref-compat|ref-exact|etsi] [--key-file keys.txt]
        [-o out.jsonl] [--chunk-size S] [--trace-dir DIR]
        [--device cuda|cpu] [-v]
    python -m tetraear_tpu_torch decode <iq> --carriers N [--pfb] [--afc]
        [--conv auto|s2d|s2d_of|pallas|pallas_bf16] ...
    python -m tetraear_tpu_torch downlink [<iq>] [--simulate --slots N]
        [--freq-offset HZ|auto] [--survey N] [--traffic-channel ...]
        [--traffic-depth 1|4|8] [-o out.jsonl] [--voice-wav w.wav]
    python -m tetraear_tpu_torch uplink [<iq>] [--simulate] [--continuous]
        [--mcc M --mnc N --colour-code C] [--anchor TN:FN:MN] [-o ...]
    python -m tetraear_tpu_torch scan START STOP [--wideband]
        [--iq-file f | --synthetic] [-f MHz] [--device cuda|cpu]
    python -m tetraear_tpu_torch waterfall <iq> [-o x.png] [--rows N]
        [--fft-size N] [--device cuda|cpu]
    python -m tetraear_tpu_torch codec encode|decode <in> [-o out]
    python -m tetraear_tpu_torch frames <log.jsonl> [--stats] [--type T]
        [--group G] [-o out.jsonl] ...
    python -m tetraear_tpu_torch devices

Mirrors the JAX package's commands (tetraear_tpu/ui/cli.py): the same
options, printed lines and JSONL. `listen` is the reference's `--no-gui`
receive loop (ui/capture_loop.CaptureLoop) on a replay file, the
synthetic source or a BladeRF, `tui` the same loop under the terminal
UI; `scan` probes channel by channel (signal/scanner.py) or, with
--wideband, sweeps one capture and validates its hot channels through
the staged multicarrier decode (K5 on a card); `waterfall` renders a
capture's spectra. `decode` without --carriers runs the single-carrier
receiver of --profile (`SignalProcessor.process_full`, then the host
`TetraDecoder.decode`); with --carriers N, N carriers of the 25 kHz
grid, or with --pfb every channel of the band (96 at 2.4 MS/s, a frame's
`carrier` its fftfreq channel index); --afc estimates the grid's shared
tuner offset per chunk (ops/spectrum.estimate_grid_offset_hz) and
derotates before the channelizer. Chunks are read with FileReplaySource,
the last chunk zero-padded to full length, the device result of chunk
i+1 queued before chunk i is decoded on the host. `downlink` decodes an
ETSI downlink (models/downlink.py; --survey N: every cell on N carriers,
the channelizer K5 on a card), `uplink` the isolated-burst or, with
--continuous, the slot-synchronous uplink monitor (models/uplink.py);
--simulate synthesizes the capture first, as the reference does.

Every command that touches tensors (`listen`, `tui`, `decode`,
`downlink`, `uplink`, `scan`, `waterfall`) runs on `--device`, cuda
unless the caller asks for the CPU with `--device cpu`; without a card a
command refuses to run and says so.  There is no fallback from one
device to the other.  `codec`, `frames` and `devices` are host work and
take no --device.  A renamed option: in the reference, `listen --device`
and `tui --device` name the BladeRF; here --device is the torch device
and the BladeRF's serial is `--sdr-device`.  A fault on the device
(kernel build or launch, CUDA error, out-of-memory) ends `listen`, `tui`,
`scan` and `waterfall` with the exception, where the reference's loop
and scanner turned it into "no signal" and exit 0.  `--conv`
defaults to `auto`, as in the reference, and resolves as the reference's
does: on the CPU the staged chain (with --pfb the gather-form
filterbank), on a card s2d.  `main` sets up the reference's per-run log
files (`ui.logging_setup`; -v puts DEBUG on the console).
"""

from __future__ import annotations

import argparse
import logging
import sys
import time
from datetime import datetime
from pathlib import Path

import torch

from tetraear_tpu_torch.config import ReceiverConfig
from tetraear_tpu_torch.models.multicarrier import CONV_VARIANTS

# the reference CLI's --conv choices that are ported ("s2d_mono" and
# "s2d_hb16" are not): "auto" and the table's CLI variants; pallas_db,
# pallas_of<N> and the staged chains by name are reached through the
# frontends' constructors, as in the reference
CLI_CONVS = ("auto",) + tuple(k for k, v in CONV_VARIANTS.items() if v.cli)

def resolve_conv(conv: str, device: torch.device, pfb: bool) -> str:
    """`auto` -> the staged chain on the CPU ("gather" with --pfb), s2d on
    a card (tetraear_tpu/ui/cli.py:699, 709); any other name as given."""
    if conv != "auto":
        return conv
    if device.type == "cpu":
        return "gather" if pfb else "staged"
    return "s2d"


def _device(name: str) -> torch.device:
    """--device as a torch device: a CUDA device needs a card, and no
    command picks the CPU unless asked (`--device cpu`)."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {name}: no CUDA device is available; "
                         "pass --device cpu to run on the CPU")
    return dev


def _out_path(args) -> str:
    return args.out_jsonl or (str(Path(args.iq_file).with_suffix(""))
                              + "_frames.jsonl")


def _receiver_config(args):
    """--profile -> ReceiverConfig (None for ref-compat, the default), as
    the reference CLI's helper of that name."""
    profile = getattr(args, "profile", "ref-compat")
    if profile == "ref-compat":
        return None
    return ReceiverConfig(profile=profile,
                          sample_rate_hz=args.sample_rate * 1e6)


def _load_keys(args, decoder) -> None:
    """--key-file: one hex key per line (`#` comments, an optional
    `name:` prefix) into decoder.set_keys, as the reference CLI's helper
    of that name."""
    if getattr(args, "key_file", None):
        keys = []
        for line in Path(args.key_file).read_text().splitlines():
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            keys.append(line.split(":")[-1])
        decoder.set_keys(keys)


def _device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "host"


_ANSI = {"red": "\x1b[31m", "green": "\x1b[32m", "yellow": "\x1b[33m",
         "blue": "\x1b[34m", "magenta": "\x1b[35m", "cyan": "\x1b[36m",
         "white": "\x1b[37m", "reset": "\x1b[0m"}


def _c(color: str, text: str) -> str:
    if sys.stdout.isatty():
        return f"{_ANSI[color]}{text}{_ANSI['reset']}"
    return text


class CLITetraListener:
    """Colored frame/status printer (ui/modern.py:5422-5493)."""

    _TYPE_COLORS = [("MAC-RESOURCE", "blue"), ("MAC-BROADCAST", "yellow"),
                    ("MAC-FRAG", "green"), ("MAC-SUPPL", "magenta"),
                    ("MAC-U-SIGNAL", "red"), ("MAC-DATA", "cyan")]

    def __init__(self, loop):
        self.loop = loop
        self.start_time = datetime.now()
        self.signal_active = False
        self.frame_count = 0
        loop.on_status = self.on_status
        loop.on_error = self.on_error
        loop.on_signal = self.on_signal
        loop.on_signal_lost = self.on_signal_lost
        loop.on_frame = self.on_frame

    def on_status(self, msg):
        print(_c("cyan", f"[STATUS] {msg}"))

    def on_error(self, msg):
        print(_c("red", f"[ERROR] {msg}"))

    def on_signal(self, freq, snr):
        if not self.signal_active:
            print(_c("green", f"[SIGNAL] TETRA Detected at {freq / 1e6:.4f} "
                              f"MHz (SNR: {snr:.1f} dB)"))
            self.signal_active = True

    def on_signal_lost(self):
        if self.signal_active:
            print(_c("yellow", f"[SIGNAL] Signal Lost "
                               f"(decoded {self.frame_count} frames)"))
            self.signal_active = False

    def on_frame(self, frame):
        self.frame_count += 1
        ts = datetime.now().strftime("%H:%M:%S.%f")[:-3]
        fn = frame.get("number", "?")
        ftype = frame.get("type_name", "Unknown")
        color = "white"
        for key, col in self._TYPE_COLORS:
            if key in ftype:
                color = col
                break
        enc = ""
        if frame.get("decrypted"):
            enc = _c("green", "[DEC]")
        elif frame.get("encrypted"):
            enc = _c("red", "[ENC]")
        content = ""
        if "sds_message" in frame:
            content = _c("cyan", f"SDS: {frame['sds_message']}")
        elif "decoded_text" in frame:
            content = _c("cyan", f"TXT: {frame['decoded_text']}")
        elif frame.get("has_voice"):
            content = _c("green", "Voice Audio")
        print(f"[{ts}] #{fn:<4} {_c(color, f'{ftype:<15}')} {enc} {content}")


def _make_source(args):
    """--iq-file (replay), --synthetic, else the BladeRF named by
    --sdr-device (the reference's `--device`)."""
    from tetraear_tpu_torch.io.replay import FileReplaySource, SyntheticSource
    if args.iq_file:
        return FileReplaySource(args.iq_file,
                                sample_rate=args.sample_rate * 1e6,
                                frequency=args.frequency * 1e6,
                                loop=getattr(args, "loop", False),
                                realtime=getattr(args, "realtime", False))
    if getattr(args, "synthetic", False):
        return SyntheticSource(active_frequencies=(args.frequency * 1e6,),
                               sample_rate=args.sample_rate * 1e6,
                               frequency=args.frequency * 1e6)
    from tetraear_tpu_torch.io.capture import BladeRFCapture
    return BladeRFCapture(frequency=args.frequency * 1e6,
                          sample_rate=args.sample_rate * 1e6,
                          gain=args.gain,
                          device_identifier=getattr(args, "sdr_device", None))


def _capture_loop(args, dev: torch.device, **kwargs):
    """The CaptureLoop of `listen` / `tui` on `dev`."""
    from tetraear_tpu_torch.ui.capture_loop import CaptureLoop
    return CaptureLoop(
        _make_source(args),
        frequency=args.frequency * 1e6,
        sample_rate=args.sample_rate * 1e6,
        auto_decrypt=args.auto_decrypt,
        always_decode=bool(args.iq_file or args.synthetic),
        afc=not args.no_afc,
        overlap=args.overlap,
        receiver_config=_receiver_config(args),
        device=dev, **kwargs)


def cmd_tui(args) -> int:
    """Interactive terminal UI (ui/tui.py): live waterfall + tables +
    SDS feed + key toggles + voice playback, the receive loop on
    --device.  A fault of the loop on the device is re-raised here."""
    from tetraear_tpu_torch.audio.playback import AudioSink
    from tetraear_tpu_torch.ui.logging_setup import get_records_dir
    from tetraear_tpu_torch.ui.tui import TerminalUI

    dev = _device(args.device)
    print(f"[DEVICE] {dev} ({_device_name(dev)}), tui")
    loop = _capture_loop(args, dev)
    _load_keys(args, loop)
    sink = AudioSink(record_dir=(str(get_records_dir())
                                 if args.record else None))
    ui = TerminalUI(loop, audio_sink=sink)
    try:
        ui.run(max_chunks=args.max_chunks, duration_s=args.duration)
    except KeyboardInterrupt:
        loop.stop(join=False)
    print(ui.state.session.summary())
    return 0


def cmd_listen(args) -> int:
    """The live / replay receive loop (the reference's `--no-gui` mode)
    on --device: frames printed, optionally written as JSONL (-o), the
    session summary at the end."""
    from tetraear_tpu_torch.io.recorder import JsonlFrameRecorder
    from tetraear_tpu_torch.ui.logging_setup import get_records_dir
    from tetraear_tpu_torch.ui.session import SessionAggregator
    from tetraear_tpu_torch.utils.metrics import profile_trace

    dev = _device(args.device)
    print(_c("cyan", "TetraEar-TPU - CLI Mode"))
    print(f"Frequency: {args.frequency} MHz")
    print(f"Gain: {args.gain} dB")
    print(f"Sample Rate: {args.sample_rate} MHz")
    print(f"[DEVICE] {dev} ({_device_name(dev)}), listen")

    loop = _capture_loop(
        args, dev, monitor_raw=args.monitor_audio,
        records_dir=str(get_records_dir()) if args.record else None)
    listener = CLITetraListener(loop)
    session = SessionAggregator()
    _orig_on_frame = loop.on_frame

    def _frame_with_session(frame):
        session.on_frame(frame)
        _orig_on_frame(frame)
    loop.on_frame = _frame_with_session
    _load_keys(args, loop)

    wf_buffer = None
    if args.waterfall:
        from tetraear_tpu_torch.ui.waterfall import WaterfallBuffer
        wf_buffer = WaterfallBuffer()
        loop.on_spectrum = lambda freqs, power: wf_buffer.update_spectrum(
            freqs, power)

    recorder = None
    if args.out_jsonl:
        recorder = JsonlFrameRecorder(args.out_jsonl)
        prev = loop.on_frame

        def on_frame(frame):
            recorder.write(frame)
            prev(frame)
        loop.on_frame = on_frame

    try:
        with profile_trace(args.trace_dir):
            loop.run(max_chunks=args.max_chunks)
    except KeyboardInterrupt:
        print(_c("yellow", "\nStopping..."))
        loop.stop(join=False)
    finally:
        if recorder:
            recorder.close()
        if wf_buffer is not None and wf_buffer.history:
            from tetraear_tpu_torch.ui.waterfall import (render_waterfall_rgb,
                                                         save_ppm)
            save_ppm(args.waterfall, render_waterfall_rgb(wf_buffer))
            print(f"Waterfall image: {args.waterfall}")
    print(f"Decoded {listener.frame_count} frames "
          f"from {loop.chunks_processed} chunks")
    print(loop.meter.summary())
    print(session.summary())
    return 0


def cmd_decode(args) -> int:
    from tetraear_tpu_torch.io.replay import FileReplaySource

    dev = _device(args.device)
    source = FileReplaySource(args.iq_file,
                              sample_rate=args.sample_rate * 1e6)
    if args.carriers > 0:
        return _decode_multicarrier(args, source, dev)
    print(f"[DEVICE] {dev} ({_device_name(dev)}), single carrier, profile "
          f"{args.profile}")
    if not source.open():
        print(f"[FAIL] Could not open {args.iq_file}")
        return 1
    return _decode_single(args, source, dev)


def _decode_single(args, source, dev: torch.device) -> int:
    """The reference's single-carrier loop (tetraear_tpu/ui/cli.py
    cmd_decode) on `dev`."""
    import numpy as np
    from tetraear_tpu_torch.io.recorder import JsonlFrameRecorder
    from tetraear_tpu_torch.core.decoder import TetraDecoder
    from tetraear_tpu_torch.models.receiver import SignalProcessor
    from tetraear_tpu_torch.utils.metrics import profile_trace

    processor = SignalProcessor(sample_rate=args.sample_rate * 1e6,
                                config=_receiver_config(args), device=dev)
    decoder = TetraDecoder(auto_decrypt=args.auto_decrypt, device=dev)
    _load_keys(args, decoder)
    out_path = _out_path(args)
    chunk = args.chunk_size
    frame_count = unencrypted = 0
    t0 = time.time()
    samples_total = 0
    # the first chunk carries the start-up (cuDNN plans, operator
    # uploads); device wait and host decode scale with the capture
    t_first = t_wait = t_decode = 0.0
    n_chunks = 0

    def _fetch_hard(res) -> np.ndarray:
        """The previous chunk's hard symbols (the loop's blocking copy)."""
        count = int(res.count)
        if count < 2:
            return np.array([], dtype=np.uint8)
        return res.hard_symbols[:count - 1].cpu().numpy()

    def _emit(demod, rec) -> None:
        nonlocal frame_count, unencrypted, t_decode
        ts = time.time()
        frames = decoder.decode(demod)
        t_decode += time.time() - ts
        for frame in frames:
            frame_count += 1
            rec.write(frame)
            if not frame.get("encrypted", True):
                unencrypted += 1
                text = (frame.get("decoded_text", "")
                        or frame.get("sds_message", ""))
                if text and not text.startswith("[BIN"):
                    print(f"[READABLE] Frame {frame_count}: {text[:100]}")

    with profile_trace(args.trace_dir), JsonlFrameRecorder(
            out_path, include_bits=not args.no_bits) as rec:
        # queue chunk i+1 on the device before fetching and host-decoding
        # chunk i
        pending = None
        while not source.exhausted:
            samples = source.read_samples(chunk)
            if len(samples) == 0:
                break
            samples_total += len(samples)
            if len(samples) < chunk:
                samples = np.pad(samples, (0, chunk - len(samples)))
            ts = time.time()
            res = processor.process_full(samples)
            t_stage = time.time() - ts
            n_chunks += 1
            if n_chunks == 1:
                t_first = t_stage
            if pending is None:
                pending = res
                continue
            ts = time.time()
            demod = _fetch_hard(pending)
            t_wait += time.time() - ts
            pending = res
            if len(demod) >= 255:
                _emit(demod, rec)
        if pending is not None:
            demod = _fetch_hard(pending)
            if len(demod) >= 255:
                _emit(demod, rec)
    dt = time.time() - t0
    rate = samples_total / max(dt, 1e-9)
    print(f"[DONE] {frame_count} frames ({unencrypted} clear) from "
          f"{samples_total} samples -> {out_path}")
    if n_chunks > 1:
        steady = (samples_total - chunk) / max(dt - t_first, 1e-9)
        wait_r = (samples_total - chunk) / max(t_wait, 1e-9)
        dec_r = (samples_total - chunk) / max(t_decode, 1e-9)
        print(f"[PERF] {steady / 1e6:.2f} MS/s steady-state pipelined "
              f"(device wait {wait_r / 1e6:.1f} MS/s, decode "
              f"{dec_r / 1e6:.1f} MS/s host); first chunk incl. start-up "
              f"{t_first:.2f}s; total {rate / 1e6:.2f} MS/s on {dev}")
    else:
        print(f"[PERF] {rate / 1e6:.2f} MS/s through demod+decode on {dev} "
              f"(single chunk, start-up included)")
    stats = decoder.protocol_parser.get_statistics()
    print(f"[STATS] bursts={stats['total_bursts']} "
          f"crc_rate={stats['crc_success_rate']:.1f}%")
    return 0


def _decode_multicarrier(args, source, dev: torch.device) -> int:
    import numpy as np
    from tetraear_tpu_torch.io.recorder import JsonlFrameRecorder
    from tetraear_tpu_torch.models.multicarrier import (
        MulticarrierDecoder, build_frontend, conv_variant)
    from tetraear_tpu_torch.ops.channelizer import carrier_grid
    from tetraear_tpu_torch.ops.spectrum import estimate_grid_offset_hz
    from tetraear_tpu_torch.utils.metrics import profile_trace

    conv = resolve_conv(args.conv, dev, args.pfb)
    try:
        runs = conv_variant(conv, pfb=args.pfb).runs
    except ValueError:                  # s2d_of, the one 16-carrier choice
        raise SystemExit(f"--conv {conv} is a 16-carrier variant; the "
                         "PFB supports auto, s2d, pallas, pallas_bf16"
                         ) from None
    if dev.type == "cpu" and conv.startswith("pallas"):
        runs += "; the kernel's plain version on the CPU"
    print(f"[DEVICE] {dev} ({_device_name(dev)}), conv {args.conv}"
          + (f" -> {conv}" if conv != args.conv else "") + f": {runs}")
    if not source.open():
        print(f"[FAIL] Could not open {args.iq_file}")
        return 1
    # with --pfb the full-band polyphase filterbank: every 25 kHz channel
    mc = build_frontend(conv, device=dev, pfb=args.pfb,
                        offsets_hz=carrier_grid(args.carriers))
    if args.pfb:
        args.carriers = mc.num_channels
    dec = MulticarrierDecoder(args.carriers, auto_decrypt=args.auto_decrypt,
                              device=dev)
    out_path = _out_path(args)
    chunk = args.chunk_size
    frame_count = 0
    per_carrier = [0] * args.carriers
    t0 = time.time()
    samples_total = 0
    start_index = 0

    def _emit(res):
        nonlocal frame_count
        for frames in dec.decode(res):
            for frame in frames:
                frame_count += 1
                per_carrier[frame["carrier"]] += 1
                rec.write(frame)

    with profile_trace(args.trace_dir), JsonlFrameRecorder(
            out_path, include_bits=not args.no_bits) as rec:
        # queue chunk i+1 on the device before host-decoding chunk i; the
        # device-to-host copies in dec.decode are the only sync points
        pending = None
        afc_hz = 0.0
        fs = args.sample_rate * 1e6
        while not source.exhausted:
            samples = source.read_samples(chunk)
            if len(samples) == 0:
                break
            samples_total += len(samples)
            if args.afc:
                # grid-comb AFC: one shared tuner offset for every carrier,
                # estimated on the real samples (before the tail padding)
                est = estimate_grid_offset_hz(samples, fs, device=dev)
            if len(samples) < chunk:
                samples = np.pad(samples, (0, chunk - len(samples)))
            if args.afc:
                # EMA-smoothed; the derotation restarts per chunk only
                # when the estimate moves by more than 1 Hz
                new = est if pending is None else 0.8 * afc_hz + 0.2 * est
                if abs(new - afc_hz) > 1.0 or pending is None:
                    afc_hz = new
                    print(f"[AFC] grid offset {afc_hz:+.0f} Hz")
                if abs(afc_hz) > 1.0:
                    t = (start_index + np.arange(len(samples))) / fs
                    samples = (samples * np.exp(-2j * np.pi * afc_hz * t)
                               ).astype(np.complex64)
            res = mc(samples, start_index=start_index)
            start_index += chunk
            if pending is not None:
                _emit(pending)
            pending = res
        if pending is not None:
            _emit(pending)
    dt = time.time() - t0
    print(f"[DONE] {frame_count} frames across {args.carriers} carriers "
          f"-> {out_path}")
    print(f"[PERF] {samples_total / max(dt, 1e-9) / 1e6:.2f} MS/s wideband "
          f"through {args.carriers}-carrier demod+decode on {dev}")
    hot = {c: n for c, n in enumerate(per_carrier) if n}
    print(f"[CARRIERS] frames per carrier: {hot}")
    return 0


def _read_iq(args):
    """The capture of a `downlink` / `uplink` run: the IQ file as
    complex64, or None (with the reference's message) without one."""
    import numpy as np
    if not args.iq_file:
        print("[FAIL] need an IQ file (or --simulate)")
        return None
    return np.fromfile(args.iq_file, dtype=np.complex64)


def _simulate_downlink(args):
    """The reference's `downlink --simulate` capture
    (models/downlink.simulate_multiframe at seed 0): SCH/F MAC blocks on
    TN2, a group call's CMCE signalling with an SDS-TL text on TN4, TN3 a
    traffic channel (real ACELP-coded speech for TCH/S where the codec
    builds, random bits otherwise), 25 dB SNR by default."""
    from tetraear_tpu_torch.models.downlink import simulate_multiframe
    sim = simulate_multiframe(args.slots, args.message, args.snr_db,
                              args.traffic_channel, args.traffic_depth,
                              voice=True)
    if sim.voiced:
        print(f"[SIM] TCH/S carries {len(sim.traffic)} blocks of real "
              "ACELP-coded speech (native/codec)")
    return sim.iq


def _downlink_record(f, describe_pdu) -> dict:
    """One decoded slot as the reference CLI's JSONL line."""
    import dataclasses
    return {
        "slot": f.slot_index, "tn": f.tn, "fn": f.fn, "mn": f.mn,
        "burst": f.burst_kind, "channel": f.channel,
        "crc_ok": None if f.crc_ok is None else bool(f.crc_ok),
        "aach_usage": f.aach.downlink_usage,
        "mcc": f.sync_pdu.mcc if f.sync_pdu else None,
        "mnc": f.sync_pdu.mnc if f.sync_pdu else None,
        "sds": f.sds_message,
        "mac_data": (bytes(f.mac_pdu.data).hex()
                     if f.mac_pdu is not None else None),
        "layer3": ([describe_pdu(r) for r in f.layer3]
                   if f.layer3 else None),
        "call": (dataclasses.asdict(f.call_metadata)
                 if f.call_metadata is not None else None),
        "voice": f.voice_block is not None}


def _downlink_line(f, describe_pdu) -> str:
    """One decoded slot as the reference CLI prints it."""
    desc = ""
    if f.sync_pdu:
        desc = (f"MCC={f.sync_pdu.mcc} MNC={f.sync_pdu.mnc} "
                f"CC={f.sync_pdu.colour_code}")
    if f.sysinfo:
        desc += (f" LA={f.sysinfo.location_area} "
                 f"carrier={f.sysinfo.main_carrier}")
    if f.mac_pdu is not None:
        desc = repr(bytes(f.mac_pdu.data))[1:]
    if f.layer3:
        desc = "; ".join(describe_pdu(r) for r in f.layer3)
    if f.sds_message:
        desc += f" {f.sds_message}"
    if f.voice_block:
        desc = f"voice block ({len(f.voice_block)} B)"
        if f.call_metadata is not None:
            desc += (f" [call {f.call_metadata.call_identifier} "
                     f"tg {f.call_metadata.talkgroup_id}]")
    crc = "-" if f.crc_ok is None else "Y" if f.crc_ok else "n"
    return (f"TN{f.tn} FN{f.fn:2d} MN{f.mn:2d} {f.burst_kind:3s} "
            f"{f.channel:11s} crc={crc} "
            f"aach={f.aach.downlink_usage:14s} {desc}")


def cmd_downlink(args) -> int:
    """Full ETSI downlink decode on --device: blind cell acquisition
    (BSCH), TDMA tracking, AACH, SCH/F signalling and TCH traffic
    (models/downlink.py); --survey N reports every cell on N carriers.
    With --simulate it synthesizes a downlink capture first."""
    import json

    import numpy as np
    from tetraear_tpu_torch.models.downlink import DownlinkReceiver
    from tetraear_tpu_torch.protocol.layer3 import describe_pdu

    dev = _device(args.device)
    print(f"[DEVICE] {dev} ({_device_name(dev)}), downlink")
    if args.simulate:
        iq = _simulate_downlink(args)
        if args.iq_file:
            iq.tofile(args.iq_file)
            print(f"[SIM] wrote {len(iq)} samples -> {args.iq_file}")
    else:
        iq = _read_iq(args)
        if iq is None:
            return 1

    if args.survey > 0:
        from tetraear_tpu_torch.models.downlink import survey_cells
        t0 = time.time()
        cells = survey_cells(iq, num_carriers=args.survey, device=dev)
        dt = time.time() - t0
        for r in cells:
            nb = (f" neighbours={','.join(map(str, r.neighbours))}"
                  if r.neighbours else "")
            print(f"carrier {r.carrier_index:3d} ({r.offset_hz/1e3:+7.1f} "
                  f"kHz): MCC={r.mcc} MNC={r.mnc} CC={r.colour_code} "
                  f"LA={r.location_area} slots={r.slots_decoded} "
                  f"crc={100*r.crc_rate:.0f}%{nb}")
        print(f"[DONE] {len(cells)} cells found across {args.survey} "
              f"carriers  [{len(iq)/max(dt,1e-9)/1e6:.2f} MS/s]")
        return 0

    rx = DownlinkReceiver(traffic_channel=args.traffic_channel,
                          traffic_depth=args.traffic_depth, device=dev)
    offset = ("auto" if args.freq_offset == "auto"
              else float(args.freq_offset))
    t0 = time.time()
    frames = rx.receive(iq, freq_offset=offset)
    dt = time.time() - t0
    if not frames:
        print("[NO CELL] no decodable synchronization burst")
        return 1

    out = open(args.out_jsonl, "w") if args.out_jsonl else None
    crc_pass = 0
    voice_blocks = 0
    try:
        for f in frames:
            crc_pass += bool(f.crc_ok)
            voice_blocks += f.voice_block is not None
            print(_downlink_line(f, describe_pdu))
            if out:
                out.write(json.dumps(_downlink_record(f, describe_pdu))
                          + "\n")
    finally:
        if out:
            out.close()
    if out:
        print(f"[OUT] {args.out_jsonl}")
    if args.traffic_depth > 1:
        # deep-interleaved data channels resolve per TN after the walk
        for t in sorted({f.tn for f in frames if f.tch_llrs is not None}):
            blocks = rx.decode_traffic_stream(frames, tn=t)
            print(f"[TCH] TN{t}: {blocks.shape[0]} "
                  f"{args.traffic_channel} blocks de-interleaved "
                  f"(depth {args.traffic_depth})")

    voice_seq = [f.voice_block for f in frames if f.voice_block]
    if voice_seq:
        # the received TCH/S blocks through the codec chain (cdecoder:
        # de-interleave + Viterbi + CRC; sdecoder: ACELP synthesis), one
        # invocation keeping the decoder state across blocks
        from tetraear_tpu_torch.audio.voice import VoiceProcessor
        vp = VoiceProcessor()
        if vp.working:
            audio = vp.decode_stream(voice_seq)
            amp = float(np.abs(audio).max()) if audio.size else 0.0
            print(f"[VOICE] {len(voice_seq)} blocks -> {audio.size} PCM "
                  f"samples ({audio.size / 8000:.2f} s, peak {amp:.3f}) "
                  "via ACELP synthesis")
            if args.voice_wav and audio.size:
                import wave
                with wave.open(args.voice_wav, "wb") as w:
                    w.setnchannels(1)
                    w.setsampwidth(2)
                    w.setframerate(8000)
                    w.writeframes((np.clip(audio, -1, 1) * 32767
                                   ).astype(np.int16).tobytes())
                print(f"[VOICE] wrote {args.voice_wav}")
        else:
            print("[VOICE] codec binaries not found (no C compiler to "
                  "build native/codec)")
    rate = len(iq) / max(dt, 1e-9) / 1e6
    print(f"[DONE] {len(frames)} slots, {crc_pass} CRC-pass, "
          f"{voice_blocks} voice blocks  [{rate:.2f} MS/s]")
    return 0


def _simulate_uplink(args, ecc: int):
    """The reference's `uplink --simulate` capture: a legacy-layout SDS
    NUB, a MAC-ACCESS control burst and two CMCE NUBs; with --continuous
    on the slot grid (signalling on odd slots, coded speech on TN3 where
    the codec builds), else as isolated bursts."""
    import numpy as np
    from tetraear_tpu_torch.models.uplink import UplinkTransmitter
    from tetraear_tpu_torch.protocol import cmce, sds_tl
    from tetraear_tpu_torch.utils.synth import make_mac_block_bits
    tx = UplinkTransmitter(ecc)
    bursts_tx = [
        tx.nub_bits(make_mac_block_bits(b"LEGACY UPLINK SDS", seed=1)),
        tx.access_cb(cmce.USdsData(called_party=cmce.Address(0, 0x2A),
                                   short_data_type=0,
                                   user_data=0xBEEF), ssi=0xABCD),
        tx.signalling_nub(cmce.USetup(
            basic_service_info=0, call_priority=5,
            called_party=cmce.Address(1, 0x2328)), ssi=0x777),
        tx.signalling_nub(cmce.USdsData(
            called_party=cmce.Address(1, 0x2328), short_data_type=3,
            data_bits=sds_tl.build_text_transfer("uplink report 7")),
            ssi=0x777),
    ]
    if not args.continuous:
        return tx.transmit(bursts_tx, snr_db=args.snr_db, seed=2)
    # slot-synchronous: signalling on odd slots and, where the codec
    # builds, ACELP-coded speech on TN3 (anchor 1:1:1 -> TN = k % 4 + 1,
    # slots 2, 6, 10, ...)
    from tetraear_tpu_torch.audio.voice import VoiceEncoder
    from tetraear_tpu_torch.ops import channel_coding as cc_ops
    slot_map = {2 * i + 1: b for i, b in enumerate(bursts_tx)
                if b.size <= 510}
    n_slots = 2 * len(bursts_tx) + 2
    venc = VoiceEncoder()
    voice_slots = [k for k in range(n_slots) if k % 4 == 2]
    if venc.working and voice_slots:
        from tetraear_tpu_torch.utils.synth import make_test_speech
        voc = venc.encode_pcm_bits(
            make_test_speech(0.06 * len(voice_slots) + 0.06)
        )[:len(voice_slots)]
        t5 = cc_ops.encode_tch(voc, "TCH/S", ecc30=ecc)
        for k, blk in zip(voice_slots, t5):
            slot_map[k] = tx.traffic_nub(blk)
        print(f"[SIM] TN3 carries {len(t5)} uplink TCH/S blocks "
              "of real ACELP-coded speech")
    return tx.transmit_slots(slot_map, n_slots, lead_bits=120,
                             snr_db=args.snr_db, seed=2)


def cmd_uplink(args) -> int:
    """Uplink monitor on --device: NUB / CB located by midamble
    correlation and decoded with the cell scrambling learned from the
    downlink (models/uplink.py); --continuous locks the slot grid and
    labels each burst with its TN/FN/MN.  With --simulate it synthesizes
    the bursts first."""
    import json

    import numpy as np
    from tetraear_tpu_torch.models.uplink import (UplinkMonitor,
                                                  UplinkSlotMonitor)
    from tetraear_tpu_torch.ops.scramble import extended_colour_code
    from tetraear_tpu_torch.protocol.layer3 import describe_pdu

    dev = _device(args.device)
    print(f"[DEVICE] {dev} ({_device_name(dev)}), uplink")
    ecc = extended_colour_code(args.mcc, args.mnc, args.colour_code)
    if args.simulate:
        iq = _simulate_uplink(args, ecc)
        if args.iq_file:
            iq.tofile(args.iq_file)
            print(f"[SIM] wrote {len(iq)} samples -> {args.iq_file}")
    else:
        iq = _read_iq(args)
        if iq is None:
            return 1

    t0 = time.time()
    if args.continuous:
        anchor = tuple(int(v) for v in args.anchor.split(":"))
        frames = UplinkSlotMonitor(ecc, anchor=anchor,
                                   traffic_tns={3: "TCH/S"},
                                   device=dev).receive(iq)
    else:
        frames = UplinkMonitor(ecc, device=dev).receive(iq)
    dt = time.time() - t0
    out = open(args.out_jsonl, "w") if args.out_jsonl else None
    try:
        for f in frames:
            desc = ""
            if f.layer3:
                desc = "; ".join(describe_pdu(r) for r in f.layer3)
            elif f.mac_pdu is not None:
                desc = repr(bytes(f.mac_pdu.data))[1:]
            if f.sds_message and f.sds_message not in desc:
                desc += f" {f.sds_message}"
            crc = "-" if f.crc_ok is None else "Y" if f.crc_ok else "n"
            grid = (f" TN{f.tn} FN{f.fn:2d} MN{f.mn:2d} slot {f.slot_index}"
                    f"{' dt%+d' % f.timing_offset if f.timing_offset else ''}"
                    if f.tn is not None else "")
            print(f"bit {f.start_bit:7d} {f.kind:3s} {f.channel:7s} "
                  f"crc={crc}{grid} {desc}")
            if out:
                out.write(json.dumps({
                    "start_bit": f.start_bit, "kind": f.kind,
                    "channel": f.channel,
                    "crc_ok": None if f.crc_ok is None else bool(f.crc_ok),
                    "sds": f.sds_message,
                    "layer3": ([describe_pdu(r) for r in f.layer3]
                               if f.layer3 else None),
                    "mac_data": (bytes(f.mac_pdu.data).hex()
                                 if f.mac_pdu is not None else None)})
                    + "\n")
    finally:
        if out:
            out.close()
    if out:
        print(f"[OUT] {args.out_jsonl}")
    voice_seq = [f.voice_block for f in frames
                 if getattr(f, "voice_block", None)]
    if voice_seq:
        from tetraear_tpu_torch.audio.voice import VoiceProcessor
        vp = VoiceProcessor()
        if vp.working:
            audio = vp.decode_stream(voice_seq)
            amp = float(np.abs(audio).max()) if audio.size else 0.0
            print(f"[VOICE] {len(voice_seq)} uplink blocks -> "
                  f"{audio.size} PCM samples ({audio.size / 8000:.2f} s, "
                  f"peak {amp:.3f}) via ACELP synthesis")
    print(f"[DONE] {len(frames)} uplink bursts "
          f"[{len(iq)/max(dt,1e-9)/1e6:.2f} MS/s]")
    return 0


def cmd_scan(args) -> int:
    """Channel-by-channel scan of START..STOP, or with --wideband one
    capture swept at once, its hot channels validated through the staged
    multicarrier decode (K5 on a card), on --device."""
    from tetraear_tpu_torch.signal.scanner import FrequencyScanner
    dev = _device(args.device)
    print(f"[DEVICE] {dev} ({_device_name(dev)}), scan")
    source = _make_source(args)
    if not source.open():
        print(_c("red", "[FAIL] Could not open source"))
        return 1
    scanner = FrequencyScanner(source, sample_rate=args.sample_rate * 1e6,
                               scan_step=25e3,
                               settle_s=0.0 if (args.iq_file or args.synthetic)
                               else 0.05, device=dev)
    start, stop = args.start * 1e6, args.stop * 1e6
    if args.wideband:
        center = (start + stop) / 2
        print(f"Wideband sweep centered {center / 1e6:.3f} MHz "
              f"({args.sample_rate:.1f} MHz span, one capture)...")
        results = [r for r in scanner.scan_wideband(center)
                   if start <= r["frequency"] <= stop]
        for r in sorted(results, key=lambda x: -x["power_db"])[:20]:
            tag = " *** TETRA" if r.get("is_tetra") else ""
            print(f"  {r['frequency_mhz']:.3f} MHz: "
                  f"{r['power_db']:.1f} dB{tag}")
        source.close()
        return 0
    print(f"Scanning {args.start:.3f} - {args.stop:.3f} MHz...")
    results = []
    freq = start
    while freq <= stop:
        result = scanner.scan_frequency(freq)
        if result["power_db"] > -60:
            results.append(result)
            tag = " *** TETRA" if result.get("is_tetra") else " *** SIGNAL"
            print(f"  {freq / 1e6:.3f} MHz: {result['power_db']:.1f} dB"
                  + tag)
        freq += 25e3
    source.close()
    if results:
        results.sort(key=lambda x: x["power_db"], reverse=True)
        best = results[0]
        print(_c("green", f"\n[OK] Best signal: "
                          f"{best['frequency'] / 1e6:.3f} MHz "
                          f"({best['power_db']:.1f} dB)"))
    else:
        print(_c("yellow", "\n[X] No strong signals found"))
    return 0


def waterfall_power(x, n_fft: int, rows: int, device) -> "np.ndarray":
    """The waterfall's power rows of capture x: (frames, n_fft) dBFS
    spectra on `device`, frames spread evenly over the capture so that
    about `rows` of them cover it (the reference's hop)."""
    from tetraear_tpu_torch.ops.spectrum import spectrum_frames_dbfs
    rows = max(1, rows)
    hop = max((len(x) - n_fft) // max(rows - 1, 1), 1) if len(x) > n_fft \
        else n_fft
    return spectrum_frames_dbfs(torch.as_tensor(x, device=device), n_fft,
                                hop).cpu().numpy()


def cmd_waterfall(args) -> int:
    """Render an IQ capture's waterfall to a PNG/PPM image: the spectra on
    --device, the reference GUI's WaterfallBuffer history, IIR denoiser
    and blue-cyan-yellow-red colormap on the host."""
    import numpy as np
    from tetraear_tpu_torch.io.replay import load_iq
    from tetraear_tpu_torch.ui.waterfall import (WaterfallBuffer,
                                                 render_waterfall_rgb,
                                                 save_png, save_ppm)

    dev = _device(args.device)
    print(f"[DEVICE] {dev} ({_device_name(dev)}), waterfall")
    x = load_iq(args.iq_file)
    if x.size == 0:
        print(_c("red", f"[FAIL] empty capture {args.iq_file}"))
        return 1
    n_fft = args.fft_size
    rows = max(1, args.rows)
    power = waterfall_power(x, n_fft, rows, dev)
    if power.shape[0] == 0:
        print(_c("red", "[FAIL] capture shorter than one FFT frame"))
        return 1

    buf = WaterfallBuffer(denoise=args.denoise, history=rows)
    freqs = np.zeros(n_fft)   # buffer keys rows by time only
    for row in power[:rows]:
        buf.update_spectrum(freqs, row)
    lo = float(np.percentile(power, 5))
    hi = float(np.percentile(power, 99.9))
    rgb = render_waterfall_rgb(buf, floor_db=lo, top_db=max(hi, lo + 1.0))
    out = Path(args.out or (str(Path(args.iq_file).with_suffix(""))
                            + "_waterfall.png"))
    if out.suffix.lower() == ".ppm":
        save_ppm(out, rgb)
    else:
        save_png(out, rgb)
    print(_c("green", f"[OK] {rgb.shape[1]}x{rgb.shape[0]} waterfall "
                      f"({lo:.1f}..{hi:.1f} dBFS) -> {out}"))
    return 0


def cmd_codec(args) -> int:
    """Offline voice-codec workflows over the codec built from
    native/codec: encode PCM/WAV -> coded .tet blocks, decode .tet ->
    WAV (host only)."""
    import wave

    import numpy as np
    from tetraear_tpu_torch import constants as C
    from tetraear_tpu_torch.audio.voice import VoiceEncoder, VoiceProcessor

    def read_pcm(path: Path) -> np.ndarray:
        if path.suffix.lower() == ".wav":
            with wave.open(str(path), "rb") as w:
                if w.getsampwidth() != 2:
                    raise SystemExit(f"{path}: need a 16-bit WAV")
                if w.getframerate() != 8000:
                    print(_c("yellow", f"note: {w.getframerate()} Hz WAV; "
                                       "codec expects 8 kHz"))
                channels = w.getnchannels()
                raw = w.readframes(w.getnframes())
            pcm = np.frombuffer(raw, np.int16)
            if channels > 1:
                pcm = pcm.reshape(-1, channels)[:, 0].copy()
            return pcm
        return np.fromfile(path, np.int16)

    def write_wav(path: Path, audio: np.ndarray) -> None:
        with wave.open(str(path), "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(8000)
            w.writeframes((np.clip(audio, -1, 1) * 32767
                           ).astype(np.int16).tobytes())

    src = Path(args.input)
    dst = Path(args.out) if args.out else None
    if args.direction == "encode":
        enc = VoiceEncoder(codec_dir=args.codec_dir)
        if not enc.working:
            print(_c("red", "[FAIL] scoder/ccoder not found (no C compiler "
                            "to build native/codec)"))
            return 1
        pcm = read_pcm(src)
        blocks = enc.encode_pcm(pcm)
        if not blocks:
            print(_c("red", "[FAIL] encode produced no blocks"))
            return 1
        dst = dst or src.with_suffix(".tet")
        dst.write_bytes(b"".join(blocks))
        print(_c("green", f"[OK] {len(pcm)} samples "
                          f"({len(pcm) / 8000:.2f} s) -> {len(blocks)} "
                          f"coded TCH/S blocks -> {dst}"))
        return 0

    vp = VoiceProcessor(codec_dir=args.codec_dir)
    if not vp.working:
        print(_c("red", "[FAIL] cdecoder/sdecoder not found (no C compiler "
                        "to build native/codec)"))
        return 1
    raw = src.read_bytes()
    blk = C.CODEC_BLOCK_BYTES
    nblk = len(raw) // blk
    blocks = [raw[i * blk:(i + 1) * blk] for i in range(nblk)]
    audio = vp.decode_stream(blocks)
    if audio.size == 0:
        print(_c("red", "[FAIL] no decodable blocks"))
        return 1
    dst = dst or src.with_suffix(".wav")
    write_wav(dst, audio)
    print(_c("green", f"[OK] {nblk} blocks -> {audio.size} PCM samples "
                      f"({audio.size / 8000:.2f} s) -> {dst}"))
    return 0


def cmd_frames(args) -> int:
    """Query a frames-JSONL log: the headless face of the reference GUI's
    Calls/Groups/Users/Message-Type dropdown filters and statistics panel
    (host only)."""
    import json
    from tetraear_tpu_torch.io.frames_query import (FrameFilter, FrameStats,
                                                    filter_frames,
                                                    format_frame_line,
                                                    frames_stats, read_frames)
    src = Path(args.log)
    if not src.exists():
        print(_c("red", f"[FAIL] {src} not found"))
        return 1
    encrypted = None
    if args.encrypted:
        encrypted = True
    elif args.clear:
        encrypted = False
    flt = FrameFilter(
        types=tuple(t.strip().lower() for t in (args.type or [])),
        group=args.group, user=args.user,
        call_type=args.call_type.lower() if args.call_type else None,
        timeslot=args.timeslot, encrypted=encrypted,
        sds_only=args.sds_only)
    matched = filter_frames(read_frames(src), flt)

    if args.stats:
        if args.out:
            # both: the matching frames written AND the panel printed, in
            # one streaming pass
            st = FrameStats()
            with open(args.out, "w", encoding="utf-8") as fp:
                for frame in matched:
                    fp.write(json.dumps(frame) + "\n")
                    st.add(frame)
        else:
            st = frames_stats(matched)
        print(f"frames={st.total} crc_pass={st.crc_pass} "
              f"encrypted={st.encrypted} decrypted={st.decrypted} "
              f"sds={st.sds}")
        for title, counter in (("types", st.by_type), ("groups", st.groups),
                               ("users", st.users),
                               ("call types", st.call_types)):
            if counter:
                items = ", ".join(f"{k}:{v}" for k, v
                                  in counter.most_common(args.top))
                print(f"  {title}: {items}")
        return 0

    count = 0
    out_fp = open(args.out, "w", encoding="utf-8") if args.out else None
    try:
        for frame in matched:
            count += 1
            if out_fp:
                out_fp.write(json.dumps(frame) + "\n")
            else:
                print(format_frame_line(frame))
    finally:
        if out_fp:
            out_fp.close()
    where = f" -> {args.out}" if args.out else ""
    print(_c("green", f"[OK] {count} frames matched{where}"))
    return 0


def cmd_devices(_args) -> int:
    """The BladeRF devices on this host (host only; exit 1 without the
    bladerf module or a device, as in the reference)."""
    from tetraear_tpu_torch.io.capture import (BLADERF_AVAILABLE,
                                               list_bladerf_devices)
    if not BLADERF_AVAILABLE:
        print("bladerf module not available on this host")
        return 1
    devices = list_bladerf_devices()
    if not devices:
        print("No BladeRF devices found")
        return 1
    for d in devices:
        print(f"serial={d['serial']} bus={d['usb_bus']} addr={d['usb_addr']}")
    return 0


def _add_common(p) -> None:
    """The receive options shared by `listen`, `tui` and `scan`."""
    p.add_argument("-f", "--frequency", type=float, default=390.865,
                   help="Frequency in MHz (default: 390.865)")
    p.add_argument("-g", "--gain", type=float, default=50.0,
                   help="RF gain in dB (default: 50.0)")
    p.add_argument("-s", "--sample-rate", type=float, default=2.4,
                   help="Sample rate in MHz (default: 2.4)")
    p.add_argument("--iq-file", type=str, default=None,
                   help="Replay IQ from file instead of hardware")
    p.add_argument("--synthetic", action="store_true",
                   help="Use a synthetic TETRA signal source")
    p.add_argument("--auto-decrypt", action=argparse.BooleanOptionalAction,
                   default=True, help="Enable auto-decryption")
    p.add_argument("--key-file", type=str, default=None,
                   help="ALG:ID:HEX key file for decryption")
    p.add_argument("--profile", type=str, default="ref-compat",
                   choices=["ref-exact", "ref-compat", "etsi"],
                   help="receiver DSP profile (default: ref-compat)")
    _add_device(p)
    p.add_argument("-v", "--verbose", action="store_true")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tetraear_tpu_torch",
        description="TETRA decode on PyTorch / CUDA")
    sub = p.add_subparsers(dest="command", required=True)

    t = sub.add_parser("tui", help="interactive terminal UI "
                       "(waterfall + tables + SDS + key toggles)")
    _add_common(t)
    _add_sdr_device(t)
    t.add_argument("--record", action="store_true",
                   help="record decoded voice to a WAV in records/")
    t.add_argument("--loop", action="store_true", help="loop replay file")
    t.add_argument("--realtime", action="store_true",
                   help="pace replay at capture rate")
    t.add_argument("--no-afc", action="store_true")
    t.add_argument("--overlap", type=int, default=0)
    t.add_argument("--max-chunks", type=int, default=None)
    t.add_argument("--duration", type=float, default=None,
                   help="exit after N seconds (headless demos)")
    t.set_defaults(func=cmd_tui)

    li = sub.add_parser("listen", help="live/replay decode loop")
    _add_common(li)
    li.add_argument("-m", "--monitor-audio", action="store_true")
    _add_sdr_device(li)
    li.add_argument("--record", action="store_true",
                    help="record codec blocks to records/")
    li.add_argument("--loop", action="store_true", help="loop replay file")
    li.add_argument("--realtime", action="store_true",
                    help="pace replay at capture rate")
    li.add_argument("--no-afc", action="store_true",
                    help="disable peak-bin AFC (use for centered replays)")
    li.add_argument("--waterfall", type=str, default=None,
                    help="write a waterfall image (PPM) on exit")
    li.add_argument("--overlap", type=int, default=0,
                    help="IQ samples of chunk overlap (recovers frames "
                         "straddling chunk edges; duplicates deduped)")
    li.add_argument("--trace-dir", type=str, default=None,
                    help="write a torch.profiler trace (Chrome trace "
                         "format, trace.json) of the session into DIR")
    li.add_argument("--max-chunks", type=int, default=None)
    li.add_argument("-o", "--out-jsonl", type=str, default=None)
    li.add_argument("--no-gui", action="store_true",
                    help="(compat flag; this build is always headless)")
    li.set_defaults(func=cmd_listen)

    d = sub.add_parser("decode", help="offline IQ file -> frames JSONL: "
                                      "one carrier (--profile), or every "
                                      "carrier of the grid (--carriers N)")
    d.add_argument("iq_file", type=str)
    d.add_argument("-s", "--sample-rate", type=float, default=2.4)
    d.add_argument("--auto-decrypt", action=argparse.BooleanOptionalAction,
                   default=False)
    d.add_argument("--key-file", type=str, default=None,
                   help="hex keys for the decrypt search, one per line")
    d.add_argument("--chunk-size", type=int, default=256 * 1024)
    d.add_argument("--profile", type=str, default="ref-compat",
                   choices=["ref-exact", "ref-compat", "etsi"],
                   help="single-carrier receiver: ref-compat = FIR "
                        "decimate + channel FIR; ref-exact = the "
                        "reference's IIR decimate + Butterworth filtfilt "
                        "(bit-exact to its captures); etsi = RRC "
                        "resample onto the true 18 kHz symbol grid")
    d.add_argument("--carriers", type=int, default=0,
                   help="decode N carriers of the 25 kHz grid instead of "
                        "the single-carrier path")
    d.add_argument("--conv", choices=CLI_CONVS, default="auto",
                   help="(with --carriers) channelizer: auto = the staged "
                        "chain on the CPU (gather-form filterbank with "
                        "--pfb), s2d on a card; " + "; ".join(
                            f"{k} = {CONV_VARIANTS[k].runs}"
                            for k in CLI_CONVS[1:]))
    _add_device(d)
    d.add_argument("--no-bits", action="store_true",
                   help="omit raw bits from the JSONL")
    d.add_argument("--pfb", action="store_true",
                   help="(with --carriers) polyphase filterbank: decode "
                        "every 25 kHz channel in the band (96 at 2.4 MS/s)")
    d.add_argument("--afc", action="store_true",
                   help="(with --carriers) estimate the shared tuner offset "
                        "of the 25 kHz channel grid from the folded "
                        "spectrum and derotate before channelizing")
    d.add_argument("--trace-dir", type=str, default=None,
                   help="write a torch.profiler trace of the decode loop "
                        "(Chrome trace format, trace.json) and its spans "
                        "and counters (spans.json) into DIR")
    d.add_argument("-o", "--out-jsonl", type=str, default=None)
    d.add_argument("-v", "--verbose", action="store_true")
    d.set_defaults(func=cmd_decode)

    dl = sub.add_parser("downlink",
                        help="full ETSI downlink decode (BSCH/AACH/TDMA)")
    dl.add_argument("iq_file", type=str, nargs="?", default=None)
    dl.add_argument("--simulate", action="store_true",
                    help="synthesize a downlink capture and decode it")
    dl.add_argument("--slots", type=int, default=16,
                    help="slots to simulate")
    dl.add_argument("--snr-db", type=float, default=25.0)
    dl.add_argument("--message", type=str, default="DOWNLINK SDS")
    dl.add_argument("--freq-offset", type=str, default="0",
                    help="carrier offset in Hz, or 'auto' (spectral-"
                         "centroid AFC)")
    dl.add_argument("--survey", type=int, default=0, metavar="N",
                    help="wideband cell survey over N 25 kHz carriers "
                         "instead of single-cell decode")
    dl.add_argument("--traffic-channel", type=str, default="TCH/S",
                    choices=["TCH/S", "TCH/7.2", "TCH/4.8", "TCH/2.4"])
    dl.add_argument("--traffic-depth", type=int, default=1,
                    choices=[1, 4, 8])
    dl.add_argument("-o", "--out-jsonl", type=str, default=None)
    dl.add_argument("--voice-wav", type=str, default=None,
                    help="write decoded TCH/S voice to a WAV file")
    _add_device(dl)
    dl.add_argument("-v", "--verbose", action="store_true")
    dl.set_defaults(func=cmd_downlink)

    ul = sub.add_parser("uplink",
                        help="isolated uplink-burst monitor (NUB/CB)")
    ul.add_argument("iq_file", type=str, nargs="?", default=None)
    ul.add_argument("--simulate", action="store_true",
                    help="synthesize uplink bursts and monitor them")
    ul.add_argument("--snr-db", type=float, default=22.0)
    ul.add_argument("--mcc", type=int, default=262)
    ul.add_argument("--mnc", type=int, default=1001)
    ul.add_argument("--colour-code", type=int, default=17,
                    help="cell identity learned from the downlink BSCH "
                         "(keys the uplink scrambling)")
    ul.add_argument("--continuous", action="store_true",
                    help="slot-synchronous monitor locked to the downlink "
                         "TDMA clock (grid acquisition + timing recovery + "
                         "TN/FN/MN labels)")
    ul.add_argument("--anchor", type=str, default="1:1:1",
                    help="(--continuous) TN:FN:MN of grid slot 0, as "
                         "learned from the downlink")
    ul.add_argument("-o", "--out-jsonl", type=str, default=None)
    _add_device(ul)
    ul.add_argument("-v", "--verbose", action="store_true")
    ul.set_defaults(func=cmd_uplink)

    sc = sub.add_parser("scan", help="scan a frequency range")
    sc.add_argument("start", type=float, help="start MHz")
    sc.add_argument("stop", type=float, help="stop MHz")
    sc.add_argument("--wideband", action="store_true",
                    help="one wideband capture + batched FFT sweep "
                         "instead of per-channel retuning")
    _add_common(sc)
    sc.set_defaults(func=cmd_scan)

    wf = sub.add_parser("waterfall",
                        help="render an IQ capture's waterfall to PNG/PPM")
    wf.add_argument("iq_file", type=str, help="IQ capture (.cf32/.sc16)")
    wf.add_argument("-o", "--out", type=str, default=None,
                    help="output image (.png or .ppm; default: "
                         "<iq>_waterfall.png)")
    wf.add_argument("--rows", type=int, default=200,
                    help="waterfall rows (default 200, the GUI's "
                         "history depth)")
    wf.add_argument("--fft-size", type=int, default=2048,
                    help="FFT size (default 2048, modern.py:1929)")
    wf.add_argument("--denoise", action=argparse.BooleanOptionalAction,
                    default=True, help="IIR spectrum denoiser (alpha=0.15)")
    _add_device(wf)
    wf.set_defaults(func=cmd_waterfall)

    co = sub.add_parser("codec",
                        help="offline ACELP codec: PCM/WAV <-> coded "
                             ".tet blocks")
    co.add_argument("direction", choices=["encode", "decode"])
    co.add_argument("input", type=str,
                    help="encode: .wav/.pcm (16-bit 8 kHz); "
                         "decode: .tet (690-short blocks)")
    co.add_argument("-o", "--out", type=str, default=None)
    co.add_argument("--codec-dir", type=str, default=None,
                    help="override codec binary directory")
    co.set_defaults(func=cmd_codec)

    fr = sub.add_parser("frames",
                        help="filter/summarize a frames JSONL log "
                             "(the GUI dropdown filters, headless)")
    fr.add_argument("log", type=str, help="frames .jsonl from decode/listen")
    fr.add_argument("--type", action="append", default=None,
                    metavar="NAME",
                    help="frame type_name (repeatable, e.g. MAC-RESOURCE)")
    fr.add_argument("--group", type=int, default=None, help="talkgroup id")
    fr.add_argument("--user", type=int, default=None,
                    help="SSI (matches source or destination)")
    fr.add_argument("--call-type", type=str, default=None,
                    help="Individual/Group/...")
    fr.add_argument("--timeslot", type=int, default=None)
    fr.add_argument("--encrypted", action="store_true",
                    help="encrypted frames only")
    fr.add_argument("--clear", action="store_true",
                    help="clear frames only")
    fr.add_argument("--sds-only", action="store_true",
                    help="frames carrying an SDS message")
    fr.add_argument("--stats", action="store_true",
                    help="print the statistics panel instead of lines")
    fr.add_argument("--top", type=int, default=8,
                    help="top-N entries per stats counter (default 8)")
    fr.add_argument("-o", "--out", type=str, default=None,
                    help="write matching frames as JSONL instead of text")
    fr.set_defaults(func=cmd_frames)

    dv = sub.add_parser("devices", help="list BladeRF devices")
    dv.set_defaults(func=cmd_devices)
    return p


def _add_device(parser) -> None:
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device (default cuda; without a card "
                             "the command refuses to run unless given "
                             "--device cpu)")


def _add_sdr_device(parser) -> None:
    parser.add_argument("--sdr-device", type=str, default=None,
                        metavar="SERIAL",
                        help="BladeRF serial to open (the reference's "
                             "--device; here --device is the torch device)")


def main(argv=None) -> int:
    from tetraear_tpu_torch.ui.logging_setup import get_log_dir, setup_logging
    args = build_parser().parse_args(argv)
    setup_logging(verbose=getattr(args, "verbose", False))
    logging.getLogger(__name__).info("Logging to: %s", get_log_dir())
    return args.func(args)
