"""Planted-burst wideband test signals, built with the reference's numpy
synthesizer (`tetraear_tpu.utils.synth`, reached through hostref)."""

from __future__ import annotations

import numpy as np

from tetraear_tpu_torch.hostref import synth
from tetraear_tpu_torch.ops.channelizer import carrier_grid


def planted_wideband(grid_indices, num_carriers: int = 16,
                     sample_rate_hz: float = 2.4e6,
                     num_frames: int = 4) -> tuple:
    """Golden-slot TETRA streams on carriers of `carrier_grid(num_carriers)`.

    Carrier k (a grid index) carries `num_frames` MAC-RESOURCE slots with
    the SDS text "CARRIER k MSG" (stream seed k), at 130 samples per
    symbol, mixed to its grid offset — the recipe of the reference's
    tests/unit/test_fused_frontend.py:TestDecisionEquivalence._wideband.
    Returns (x complex64, {k: "[TXT] CARRIER k MSG"})."""
    sy = synth()
    offsets = carrier_grid(num_carriers)
    fs = sample_rate_hz
    x = None
    want = {}
    for k in grid_indices:
        st = sy.make_stream_bits(
            num_frames=num_frames, lead_bits=64, seed=k, golden=True,
            payload=f"CARRIER {k} MSG".encode()[:20])
        ph = sy.synthesize_symbol_phasors(sy.bits_to_symbols(st),
                                          mapping="ref")
        iq = sy.upsample_hold(ph, fs, fs / 130.0)
        if x is None:
            x = np.zeros(len(iq), np.complex64)
        t = np.arange(len(x)) / fs
        x += (iq[:len(x)] * np.exp(2j * np.pi * float(offsets[k]) * t)
              ).astype(np.complex64)
        want[k] = f"[TXT] CARRIER {k} MSG"
    return x, want
