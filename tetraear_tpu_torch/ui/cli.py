"""Command line of the port: `decode`, single-carrier or wideband.

    python -m tetraear_tpu_torch decode <iq>
        [--profile ref-compat|ref-exact|etsi] [--key-file keys.txt]
        [-o out.jsonl] [--chunk-size S] [--device cuda|cpu]
    python -m tetraear_tpu_torch decode <iq> --carriers N [--pfb]
        [--conv auto|s2d|s2d_of|pallas|pallas_bf16] ...

Mirrors `tetraear_tpu decode` (tetraear_tpu/ui/cli.py cmd_decode and
_decode_multicarrier).  Without --carriers it runs the single-carrier
receiver of --profile (`SignalProcessor.process_full`, then the host
`TetraDecoder.decode`); with --carriers N, N carriers of the 25 kHz grid,
or with --pfb every channel of the band (96 at 2.4 MS/s, a frame's
`carrier` its fftfreq channel index).  Chunks are read with
FileReplaySource, the last chunk zero-padded to full length, the device
result of chunk i+1 queued before chunk i is decoded on the host, with
the reference's [READABLE]/[DONE]/[PERF]/[STATS] lines (single carrier)
or [DONE]/[PERF]/[CARRIERS] lines (wideband).  The device is explicit:
`--device` or, by default, cuda when a card is present and cpu
otherwise, printed as [DEVICE]; there is no fallback from one to the
other.  `--conv auto` resolves as the reference's does: on the CPU the
staged chain (with --pfb the gather-form filterbank), on a card s2d.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import torch

# the reference CLI's profile and key-file helpers (its module imports
# only the standard library at its top, so no jax)
from tetraear_tpu.ui.cli import _load_keys, _receiver_config
from tetraear_tpu_torch.models.multicarrier import CONV_VARIANTS

# the reference CLI's --conv choices that are ported ("s2d_mono" and
# "s2d_hb16" are not): "auto" and the table's CLI variants; pallas_db,
# pallas_of<N> and the staged chains by name are reached through the
# frontends' constructors, as in the reference
CLI_CONVS = ("auto",) + tuple(k for k, v in CONV_VARIANTS.items() if v.cli)

_LATER = {"afc": "--afc (grid-comb AFC) is not ported yet: it needs "
                 "ops/spectrum.py (ROADMAP.md Queue 1, Slice 6)"}


def resolve_conv(conv: str, device: torch.device, pfb: bool) -> str:
    """`auto` -> the staged chain on the CPU ("gather" with --pfb), s2d on
    a card (tetraear_tpu/ui/cli.py:699, 709); any other name as given."""
    if conv != "auto":
        return conv
    if device.type == "cpu":
        return "gather" if pfb else "staged"
    return "s2d"


def _device(name: str | None) -> torch.device:
    if name is None:
        name = "cuda" if torch.cuda.is_available() else "cpu"
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {name}: no CUDA device is available")
    return dev


def _out_path(args) -> str:
    return args.out_jsonl or (str(Path(args.iq_file).with_suffix(""))
                              + "_frames.jsonl")


def _device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "host"


def cmd_decode(args) -> int:
    from tetraear_tpu.io.replay import FileReplaySource

    for flag, msg in _LATER.items():
        if getattr(args, flag):
            raise SystemExit(msg)
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
    from tetraear_tpu.io.recorder import JsonlFrameRecorder
    from tetraear_tpu_torch.core.decoder import TetraDecoder
    from tetraear_tpu_torch.models.receiver import SignalProcessor

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

    with JsonlFrameRecorder(out_path, include_bits=not args.no_bits) as rec:
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
    from tetraear_tpu.io.recorder import JsonlFrameRecorder
    from tetraear_tpu_torch.models.multicarrier import (
        MulticarrierDecoder, build_frontend)
    from tetraear_tpu_torch.ops.channelizer import carrier_grid

    conv = resolve_conv(args.conv, dev, args.pfb)
    if args.pfb and not CONV_VARIANTS[conv].pfb:
        raise SystemExit(f"--conv {conv} is a 16-carrier variant; the "
                         "PFB supports auto, s2d, pallas, pallas_bf16")
    runs = CONV_VARIANTS[conv].runs
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
    dec = MulticarrierDecoder(args.carriers, auto_decrypt=args.auto_decrypt)
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

    with JsonlFrameRecorder(out_path, include_bits=not args.no_bits) as rec:
        # queue chunk i+1 on the device before host-decoding chunk i; the
        # device-to-host copies in dec.decode are the only sync points
        pending = None
        while not source.exhausted:
            samples = source.read_samples(chunk)
            if len(samples) == 0:
                break
            samples_total += len(samples)
            if len(samples) < chunk:
                samples = np.pad(samples, (0, chunk - len(samples)))
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


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tetraear_tpu_torch",
        description="TETRA decode on PyTorch / CUDA")
    sub = p.add_subparsers(dest="command", required=True)
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
    d.add_argument("--conv", choices=CLI_CONVS, default="pallas_bf16",
                   help="(with --carriers) channelizer: auto = the staged "
                        "chain on the CPU (gather-form filterbank with "
                        "--pfb), s2d on a card; " + "; ".join(
                            f"{k} = {CONV_VARIANTS[k].runs}"
                            for k in CLI_CONVS[1:]))
    d.add_argument("--device", type=str, default=None,
                   help="torch device (default: cuda if available, "
                        "else cpu)")
    d.add_argument("--no-bits", action="store_true",
                   help="omit raw bits from the JSONL")
    d.add_argument("--pfb", action="store_true",
                   help="(with --carriers) polyphase filterbank: decode "
                        "every 25 kHz channel in the band (96 at 2.4 MS/s)")
    d.add_argument("--afc", action="store_true", help="not ported yet")
    d.add_argument("-o", "--out-jsonl", type=str, default=None)
    d.set_defaults(func=cmd_decode)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.func(args)
