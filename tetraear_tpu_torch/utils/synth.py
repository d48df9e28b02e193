"""Planted-burst wideband test signals, built with the reference's numpy
synthesizer (`tetraear_tpu.utils.synth`, reached through hostref)."""

from __future__ import annotations

import numpy as np

from tetraear_tpu_torch.hostref import synth
from tetraear_tpu_torch.ops.channelizer import carrier_grid
from tetraear_tpu_torch.ops.pfb import channel_offsets_hz


def planted(carriers: dict, sample_rate_hz: float = 2.4e6,
            num_frames: int = 4) -> np.ndarray:
    """Golden-slot TETRA streams mixed to their offsets: `carriers` maps
    offset_hz -> (stream seed, SDS text payload).  Each carries
    `num_frames` MAC-RESOURCE slots at 130 samples per symbol — the recipe
    of the reference's tests/unit/test_fused_frontend.py:
    TestDecisionEquivalence._wideband and test_pfb.py:TestPfbFrontend."""
    sy = synth()
    fs = sample_rate_hz
    x = None
    for off, (seed, payload) in carriers.items():
        st = sy.make_stream_bits(num_frames=num_frames, lead_bits=64,
                                 seed=seed, golden=True,
                                 payload=payload.encode()[:20])
        ph = sy.synthesize_symbol_phasors(sy.bits_to_symbols(st),
                                          mapping="ref")
        iq = sy.upsample_hold(ph, fs, fs / 130.0)
        if x is None:
            x = np.zeros(len(iq), np.complex64)
        t = np.arange(len(x)) / fs
        x += (iq[:len(x)] * np.exp(2j * np.pi * float(off) * t)
              ).astype(np.complex64)
    return x


def planted_wideband(grid_indices, num_carriers: int = 16,
                     sample_rate_hz: float = 2.4e6,
                     num_frames: int = 4) -> tuple:
    """Carrier k (a grid index of `carrier_grid(num_carriers)`) carries
    the SDS text "CARRIER k MSG" (stream seed k).  Returns (x complex64,
    {k: "[TXT] CARRIER k MSG"})."""
    offsets = carrier_grid(num_carriers)
    x = planted({float(offsets[k]): (k, f"CARRIER {k} MSG")
                 for k in grid_indices}, sample_rate_hz, num_frames)
    return x, {k: f"[TXT] CARRIER {k} MSG" for k in grid_indices}


def planted_pfb(offsets_hz=(-50e3, 0.0, 75e3), sample_rate_hz: float = 2.4e6,
                num_frames: int = 4) -> tuple:
    """The full-band filterbank's planted signal (the reference's
    test_pfb.py:TestPfbFrontend recipe): the i-th offset (a multiple of
    25 kHz) carries "PFB CH i+1" (stream seed i+1).  Returns (x
    complex64, {fftfreq channel index: "[TXT] PFB CH i+1"})."""
    num_channels = int(round(sample_rate_hz / 25e3))
    chans = channel_offsets_hz(num_channels, sample_rate_hz)
    carriers = {off: (i + 1, f"PFB CH {i + 1}")
                for i, off in enumerate(offsets_hz)}
    x = planted(carriers, sample_rate_hz, num_frames)
    want = {int(np.argmin(np.abs(chans - off))): f"[TXT] {payload}"
            for off, (_seed, payload) in carriers.items()}
    return x, want


def planted_grid(grid_indices=(3, 8, 12), num_carriers: int = 16,
                 sample_rate_hz: float = 2.4e6, num_frames: int = 4) -> tuple:
    """The real-pair frontend's planted signal on the bench's grid-aligned
    offsets (k - C//2) * 25 kHz, which its mixer table takes (the odd
    multiples of 12.5 kHz of carrier_grid(16) are off that grid): index k
    carries "GRID k MSG" (stream seed k), the length cut to a multiple of
    the table's 96-sample period.  Returns (x complex64, offsets_hz,
    {k: "[TXT] GRID k MSG"})."""
    offsets = ((np.arange(num_carriers) - num_carriers // 2) * 25e3
               ).astype(np.float32)
    x = planted({float(offsets[k]): (k, f"GRID {k} MSG")
                 for k in grid_indices}, sample_rate_hz, num_frames)
    period = int(round(sample_rate_hz / 25e3))
    x = x[:len(x) // period * period]
    return x, offsets, {k: f"[TXT] GRID {k} MSG" for k in grid_indices}


def planted_single(profile: str = "ref-compat", payload: str = "HELLO HELLO",
                   num_frames: int = 4, seed: int = 2,
                   sample_rate_hz: float = 2.4e6) -> tuple:
    """One carrier at 0 Hz of golden MAC-RESOURCE slots carrying the SDS
    text `payload`, as tools/make_fixture.py makes it for each profile:
    the reference's transition mapping at 130 samples per symbol for
    ref-compat and ref-exact, true pi/4-DQPSK at 18 kHz for etsi.
    Returns (x complex64, "[TXT] payload")."""
    sy = synth()
    etsi = profile == "etsi"
    st = sy.make_stream_bits(num_frames=num_frames, lead_bits=64, seed=seed,
                             golden=True, payload=payload.encode())
    ph = sy.synthesize_symbol_phasors(sy.bits_to_symbols(st),
                                      mapping="pi4" if etsi else "ref")
    x = sy.upsample_hold(ph, sample_rate_hz,
                         18000.0 if etsi else sample_rate_hz / 130.0)
    return x.astype(np.complex64), f"[TXT] {payload}"
