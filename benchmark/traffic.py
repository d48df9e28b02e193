"""The one traffic generator: a traffic file's parameters and a seed ->
a ring of distinct chunks cut from one continuous synthetic capture.

The recipe is frozen from tetraear_tpu_torch/utils/synth.py: `planted`
(:337; symbols held for `samples_per_symbol` samples at the reference's
transitions {0, +pi/2, -pi/2, pi}, synthesize_symbol_phasors :40 and
upsample_hold :47) and the band limit and levels of `planted_scan`
(:362-375; flat to `band_flat_hz`, a cosine taper to `band_edge_hz`,
amplitude `amplitude`, complex noise of `noise_rms` per sample).  Every
carrier with traffic sends MAC-RESOURCE slots back to back, as a base
station's main carrier does in every slot; each slot carries an SDS text.

From the seed: which carriers carry traffic, each carrier's pool of
slots and texts, the order of the slots, each carrier's slot phase
(lead-in symbols) and carrier phase, and where the noise starts.  The
noise itself is one sequence for every seed (`noise_seed`), rotated by
a seeded offset: the host decode's work on noise (its false syncs) is
then the same from seed to seed, in another order.  The IQ is made on
`device` in a few large calls.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from benchmark import golden as G

_WORDS = ("UNIT", "TEAM", "CAR", "BASE", "GATE", "ZONE", "CREW", "POST")
# dibit -> quarter turns of the reference's transitions 0, +pi/2, -pi/2, pi
_QUARTERS = np.array([0, 1, 3, 2], np.int64)


@dataclass
class Ring:
    chunks: list           # R host numpy complex64 arrays of `chunk` samples
    busy: list             # receiver rows that carry traffic
    slots: dict            # row -> {510 slot bits as bytes: "[TXT] text"}
    chunk: int


def seed_rng(seed: int) -> np.random.Generator:
    """Any whole number, negative or past 64 bits too, seeds the host RNG."""
    return np.random.default_rng(int(seed) % (1 << 64))


def _text(rng, row: int) -> str:
    return (f"{_WORDS[rng.integers(len(_WORDS))]} {rng.integers(1000):03d}"
            f" CH{row:02d}")


def make_ring(params: dict, offsets_hz, sample_rate_hz: float, seed: int,
              device) -> Ring:
    """params: the traffic file merged with the cell file's keys.
    offsets_hz: each receiver row's carrier offset."""
    rng = seed_rng(seed)
    fs = float(sample_rate_hz)
    chunk = int(params["chunk"])
    n = chunk * int(params["ring_chunks"])
    offsets = np.asarray(offsets_hz, np.float64)
    busy = sorted(rng.choice(len(offsets), int(params["busy_carriers"]),
                             replace=False).tolist())
    sps = int(params["samples_per_symbol"])
    n_sym = -(-n // sps)
    pool = int(params["slot_pool"])
    slots = {}
    streams = np.empty((len(busy), n_sym), np.int64)
    for i, row in enumerate(busy):
        texts = [_text(rng, row) for _ in range(pool)]
        bits = [G.mac_resource_slot(t.encode(), int(rng.integers(1 << 31)))
                for t in texts]
        slots[row] = {b.tobytes(): f"[TXT] {t}" for b, t in zip(bits, texts)}
        lead = int(rng.integers(G.SYMBOLS_PER_SLOT))
        order = rng.integers(pool, size=-(-n_sym // G.SYMBOLS_PER_SLOT) + 1)
        stream = np.concatenate(
            [rng.integers(0, 2, 2 * lead).astype(np.uint8)]
            + [bits[j] for j in order])
        dibits = (stream[0:2 * n_sym:2] << 1) | stream[1:2 * n_sym:2]
        # the phasor before the first symbol is the carrier's phase 0
        streams[i] = np.cumsum(_QUARTERS[dibits]) % 4
    phase0 = rng.uniform(0, 2 * math.pi, len(busy))
    gen = torch.Generator(device=device)
    gen.manual_seed(int(params["noise_seed"]))
    noise_at = int(rng.integers(n))

    q = torch.as_tensor(streams, device=device)
    q = torch.cat([torch.zeros_like(q[:, :1]), q[:, :-1]], dim=1)
    sym = torch.polar(torch.ones(q.shape, dtype=torch.float64, device=device),
                      q.to(torch.float64) * (math.pi / 2)
                      + torch.as_tensor(phase0, device=device)[:, None])
    y = sym.repeat_interleave(sps, dim=1)[:, :n].to(torch.complex64)
    f = torch.fft.fftfreq(n, 1.0 / fs, device=device).abs()
    edge, flat = float(params["band_edge_hz"]), float(params["band_flat_hz"])
    mask = 0.5 - 0.5 * torch.cos(math.pi * ((edge - f) / (edge - flat))
                                 .clamp(0.0, 1.0))
    y = torch.fft.ifft(torch.fft.fft(y, dim=1) * mask, dim=1)
    t = torch.arange(n, dtype=torch.float64, device=device)
    fc = torch.as_tensor(offsets[busy], device=device)[:, None]
    mix = torch.polar(torch.ones((), dtype=torch.float64, device=device),
                      2 * math.pi * torch.remainder(fc * t, fs) / fs)
    x = (y * mix.to(torch.complex64)).sum(dim=0) * float(params["amplitude"])
    noise = torch.randn((2, n), generator=gen, device=device).roll(
        noise_at, dims=1)
    x = x + torch.complex(noise[0], noise[1]) * (float(params["noise_rms"])
                                                 / math.sqrt(2))
    host = x.to(torch.complex64).cpu().numpy()
    return Ring([host[i * chunk:(i + 1) * chunk].copy()
                 for i in range(int(params["ring_chunks"]))],
                busy, slots, chunk)
