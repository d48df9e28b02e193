"""Generate recorded-IQ regression fixtures with known content (the port's
copy of tools/make_fixture.py: the same arguments and files).

Host numpy only (utils/synth, models/downlink.DownlinkTransmitter), so it
takes no --device.

    python -m tetraear_tpu_torch.tools.make_fixture out.cf32 [--frames N]
        [--snr DB] [--offset-hz HZ] [--payload TEXT] [--seed S]
        [--mapping ref|pi4] [--true-rate] [--downlink --slots N]
"""

from __future__ import annotations

import argparse

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m tetraear_tpu_torch.tools.make_fixture")
    ap.add_argument("out", type=str)
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--snr", type=float, default=None)
    ap.add_argument("--offset-hz", type=float, default=0.0)
    ap.add_argument("--payload", type=str, default="HELLO HELLO")
    ap.add_argument("--seed", type=int, default=2)
    ap.add_argument("--mapping", choices=["ref", "pi4"], default="ref",
                    help="transition mapping: 'ref' decodes through the "
                         "reference-parity chain; 'pi4' is true pi/4-DQPSK "
                         "(decode with --profile etsi)")
    ap.add_argument("--true-rate", action="store_true",
                    help="use the real 18 kHz symbol rate (etsi profile "
                         "territory) instead of the 130-sample ref grid")
    ap.add_argument("--downlink", action="store_true",
                    help="generate a full ETSI TDMA downlink capture "
                         "(SB/SYSINFO/AACH + SDS on SCH/F + TCH/S voice) "
                         "instead of bare golden slots; decode with "
                         "'tetraear_tpu_torch downlink <file>'")
    ap.add_argument("--slots", type=int, default=16,
                    help="(--downlink) TDMA slots to generate")
    args = ap.parse_args(argv)

    from tetraear_tpu_torch.io.replay import save_iq
    from tetraear_tpu_torch.utils import synth

    if args.downlink:
        from tetraear_tpu_torch.models.downlink import (DownlinkConfig,
                                                        DownlinkTransmitter)
        rng = np.random.default_rng(args.seed)
        tx = DownlinkTransmitter(DownlinkConfig())
        payloads = {k: synth.make_mac_block_bits(
            args.payload.encode()[:29], seed=args.seed + k)
            for k in range(args.slots) if k % 4 == 1}
        voc = rng.integers(0, 2, (max(1, args.slots // 4), 432)
                           ).astype(np.uint8)
        bits = tx.stream_bits(args.slots, payloads=payloads,
                              tch_streams={3: ("TCH/S", voc, 1)})
        iq = tx.modulate(bits, snr_db=args.snr, seed=args.seed)
        if args.offset_hz:
            t = np.arange(len(iq)) / 2.4e6
            iq = (iq * np.exp(2j * np.pi * args.offset_hz * t))
        save_iq(args.out, iq.astype(np.complex64), sample_rate=2.4e6,
                center_frequency=392.5e6)
        print(f"wrote {args.out}: {len(iq)} samples, {args.slots} "
              f"downlink TDMA slots")
        return 0

    stream = synth.make_stream_bits(num_frames=args.frames, lead_bits=64,
                                    seed=args.seed, golden=True,
                                    payload=args.payload.encode())
    syms = synth.bits_to_symbols(stream)
    phasors = synth.synthesize_symbol_phasors(syms, mapping=args.mapping)
    # default grid: symbol period exactly 130 capture samples, what the
    # ref-compat integer-sps chain samples on; --true-rate uses the real
    # 18 kHz TETRA rate instead
    symbol_rate = 18000.0 if args.true_rate else 2.4e6 / 130.0
    iq = synth.upsample_hold(phasors, 2.4e6, symbol_rate)
    if args.offset_hz:
        t = np.arange(len(iq)) / 2.4e6
        iq = iq * np.exp(2j * np.pi * args.offset_hz * t)
    if args.snr is not None:
        rng = np.random.default_rng(args.seed)
        std = 10 ** (-args.snr / 20) / np.sqrt(2)
        iq = iq + std * (rng.standard_normal(len(iq))
                         + 1j * rng.standard_normal(len(iq)))
    save_iq(args.out, iq.astype(np.complex64), sample_rate=2.4e6,
            center_frequency=392.5e6)
    print(f"wrote {args.out}: {len(iq)} samples, {args.frames} golden frames")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
