"""Downlink sensitivity characterization: CRC-pass rate against SNR (the
port's copy of tools/sensitivity_sweep.py, the receiver on --device).

Sweeps AWGN over a synthesized ETSI TDMA downlink and prints the slots'
CRC-pass rate per SNR point, one JSON line each: the receive chain's
sensitivity curve.  SNR is wideband-referenced (noise power across the
full 2.4 MHz capture); the 25 kHz channel gains ~19.8 dB through the
channel filter, so in-band SNR = wideband + 19.8 dB.

The JAX tool runs on the CPU; this one runs `DownlinkReceiver` on
--device (cuda by default), so that the card's CRC decisions at the edge
of decodability can be held against the CPU's (`sweep` yields each
seed's per-slot verdicts beside the line).

    python -m tetraear_tpu_torch.tools.sensitivity_sweep [--slots N]
        [--seeds K] [--snrs DB ...] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json

SNRS = (-6, -8, -10, -12, -13, -14, -15, -16)


def sweep(snrs=SNRS, slots: int = 12, seeds: int = 3, *, device):
    """Yields (row, verdicts) per SNR: the tool's JSON row and, per seed,
    the list of the received frames' `crc_ok`."""
    from tetraear_tpu_torch.models.downlink import (DownlinkConfig,
                                                    DownlinkReceiver,
                                                    DownlinkTransmitter)
    from tetraear_tpu_torch.utils.synth import make_mac_block_bits

    tx = DownlinkTransmitter(DownlinkConfig())
    pay = {k: make_mac_block_bits(b"SENSITIVITY", seed=k)
           for k in range(slots) if k % 4 != 0}
    bits = tx.stream_bits(slots, payloads=pay)
    expected = slots - 1           # lead-in costs the last partial slot

    for snr in snrs:
        ok = tot = acquired = 0
        verdicts = []
        for seed in range(seeds):
            iq = tx.modulate(bits, snr_db=snr, seed=seed)
            frames = DownlinkReceiver(device=device).receive(iq)
            verdicts.append([f.crc_ok for f in frames])
            acquired += bool(frames)
            tot += expected
            ok += sum(1 for f in frames if f.crc_ok)
        yield {"snr_wideband_db": snr,
               "snr_inband_db": round(snr + 19.8, 1),
               "crc_pass_rate": round(ok / tot, 3),
               "acquisition_rate": round(acquired / seeds, 2)}, verdicts


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m tetraear_tpu_torch.tools.sensitivity_sweep")
    ap.add_argument("--slots", type=int, default=12)
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--snrs", type=float, nargs="*", default=list(SNRS))
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device (default cuda; without a card the "
                         "tool refuses to run unless given --device cpu)")
    args = ap.parse_args(argv)

    from tetraear_tpu_torch.ui.cli import _device
    device = _device(args.device)
    for row, _ in sweep(args.snrs, args.slots, args.seeds, device=device):
        print(json.dumps(row))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
