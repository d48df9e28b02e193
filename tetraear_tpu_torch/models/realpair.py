"""Complex-free multicarrier pipeline (port of
`tetraear_tpu.models.realpair`): every stage on (re, im) f32 pairs.

For carriers on the 25 kHz grid at fs = 2.4 MS/s every oscillator is
periodic in fs / spacing = 96 samples, so the mixer is a broadcast
multiply against a (2, C, 96) table (`mixer_table`); the decimating FIR
and the channel FIR are real strided convolutions; the demod tail
(`_demod_from_pair`) is the best-phase timing, the sector quantizer on z
and the sync scores, with the candidates stage appended for k > 0.

`StagedState` carries what the staged frontends filter and mix with;
`staged_state_from_reference` builds it from the reference's own arrays.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from tetraear_tpu.config import ReceiverConfig
from tetraear_tpu_torch.models.candidates import (CandidateStage,
                                                  candidate_stage)
from tetraear_tpu_torch.ops import dqpsk, fir, pfb, sync
from tetraear_tpu_torch.ops.crc import crc_tables
from tetraear_tpu_torch.ops.fir import _conv1d_real


class RealPairResult(NamedTuple):
    bits: torch.Tensor        # (C, B) uint8
    sync_corr: torch.Tensor   # (C, B-21) float32
    count: torch.Tensor       # (C,) int32
    best_phase: torch.Tensor  # (C,) int32


class RealPairDecodeResult(NamedTuple):
    """RealPairResult + the candidates stage (MulticarrierResult's fields
    and best_phase)."""
    bits: torch.Tensor        # (C, B) uint8
    sync_corr: torch.Tensor   # (C, B-21) float32
    count: torch.Tensor       # (C,) int32
    best_phase: torch.Tensor  # (C,) int32
    cand_pos: torch.Tensor    # (C, K) int32
    cand_corr: torch.Tensor   # (C, K) float32
    cand_valid: torch.Tensor  # (C, K) bool
    frame_bits: torch.Tensor  # (C, K, 510) uint8
    crc_ok: torch.Tensor      # (C, K) bool


@functools.lru_cache(maxsize=None)
def _mixer_table(sample_rate: float, spacing: float,
                 offsets_bytes: bytes) -> np.ndarray:
    offsets = np.frombuffer(offsets_bytes, np.float32)
    period = int(round(sample_rate / spacing))
    n = np.arange(period)
    ph = -2.0 * np.pi * offsets[:, None] * n[None, :] / sample_rate
    return np.stack([np.cos(ph), np.sin(ph)], axis=0).astype(np.float32)


def mixer_table(offsets_hz, sample_rate: float,
                spacing: float = 25e3) -> np.ndarray:
    """(2, C, period) cos/sin table of exp(-j 2pi f_c n / fs) over one
    period; the offsets must lie on the spacing grid."""
    offsets = np.asarray(offsets_hz, np.float32)
    assert np.allclose(offsets % spacing, 0) or \
        np.allclose((offsets % spacing) - spacing, 0, atol=1e-3), \
        "offsets must lie on the channel grid"
    return _mixer_table(float(sample_rate), float(spacing), offsets.tobytes())


@dataclass(frozen=True)
class StagedState:
    """What the staged frontends mix and filter with: the carrier offsets,
    the sample rate, the decimation D, the decimating and channel FIR taps
    and, for the real-pair frontend, the (2, C, period) mixer table."""
    offsets_hz: np.ndarray
    sample_rate_hz: float
    decim: int
    taps_d: np.ndarray
    taps_c: np.ndarray
    table: np.ndarray | None = None


def staged_state_from_reference(taps_d, taps_c, offsets_hz,
                                config: ReceiverConfig | None = None,
                                table=None) -> StagedState:
    """StagedState from the reference's own arrays (its
    design_decimation_fir, design_channel_fir and mixer_table outputs),
    so both packages filter and mix with identical numbers."""
    cfg = config or ReceiverConfig()
    return StagedState(
        np.asarray(offsets_hz, np.float32), float(cfg.sample_rate_hz),
        cfg.decimation_factor, np.asarray(taps_d, np.float32),
        np.asarray(taps_c, np.float32),
        None if table is None else np.asarray(table, np.float32))


def staged_state(offsets_hz, config: ReceiverConfig | None = None,
                 table: bool = False) -> StagedState:
    """StagedState built with this package's designers (the reference's
    `_multicarrier_block` recipe); table=True adds the mixer table."""
    cfg = config or ReceiverConfig()
    decim = cfg.decimation_factor
    cutoff = (cfg.channel_bandwidth_hz / 2) / (cfg.intermediate_rate_hz / 2)
    return staged_state_from_reference(
        fir.design_decimation_fir(decim, cfg.decim_fir_taps_per_phase),
        fir.design_channel_fir(cfg.channel_fir_taps, cutoff), offsets_hz,
        cfg, mixer_table(offsets_hz, cfg.sample_rate_hz) if table else None)


def _demod_from_pair(yr: torch.Tensor, yi: torch.Tensor, sps: int,
                     k: int = 0, threshold: float = 0.80,
                     z_rot: tuple | None = None, crc: tuple | None = None):
    """Channel-rate (C, M) pair -> RealPairResult, or with k > 0
    RealPairDecodeResult (the candidates stage appended; crc = (crc_a,
    crc_c0) of ops.crc.crc_tables(200, device), made here if None).

    z_rot: optional per-carrier (cos, sin) tensors of the deferred
    residual rotation (ops.fused.symbol_rotation), applied to z.  As in
    the reference, z = 0 falls into bin 3 here."""
    m_dec = yr.shape[-1]
    m = m_dec // sps
    grid_r = yr[:, :m * sps].reshape(-1, m, sps)          # (C, M, sps)
    grid_i = yi[:, :m * sps].reshape(-1, m, sps)
    phase_power = (grid_r ** 2 + grid_i ** 2).sum(dim=1)  # (C, sps)
    best = torch.argmax(phase_power, dim=-1)              # first index on ties
    count = torch.div(m_dec - best, sps, rounding_mode="floor")

    # symbol pick at the best phase: a gather equals the reference's
    # one-hot einsum exactly (x*1 + 0*others)
    idx = best[:, None, None].expand(-1, m, 1)
    sym_r = torch.gather(grid_r, 2, idx)[..., 0]          # (C, M)
    sym_i = torch.gather(grid_i, 2, idx)[..., 0]

    zr = sym_r[:, 1:] * sym_r[:, :-1] + sym_i[:, 1:] * sym_i[:, :-1]
    zi = sym_i[:, 1:] * sym_r[:, :-1] - sym_r[:, 1:] * sym_i[:, :-1]
    if z_rot is not None:
        cd = z_rot[0][:, None]
        sd = z_rot[1][:, None]
        zr, zi = zr * cd + zi * sd, zi * cd - zr * sd
    hard = dqpsk.quantize_z_ref(zr, zi)
    bits = dqpsk.symbols_to_bits(hard)
    corr = sync.best_correlation(bits)
    count, best = count.to(torch.int32), best.to(torch.int32)
    if k <= 0:
        return RealPairResult(bits, corr, count, best)
    crc = crc if crc is not None else crc_tables(200, yr.device)
    res = candidate_stage(bits, corr, count, k, threshold, *crc)
    return RealPairDecodeResult(bits, corr, count, best, *res[3:])


def _realpair_block(x_ri: torch.Tensor, table: torch.Tensor, taps_d,
                    taps_c, decim: int, sps: int, k: int = 0,
                    threshold: float = 0.80, crc: tuple | None = None):
    """x_ri (2, N) f32, table (2, C, P) f32, N % P == 0 -> the demod
    tail's result: table mixer, decimating FIR, channel FIR, all real."""
    n = x_ri.shape[-1]
    period = table.shape[-1]
    assert n % period == 0, (n, period)
    xt = x_ri.reshape(2, 1, n // period, period)
    oc = table[0][:, None, :]                    # cos, (C, 1, P)
    osn = table[1][:, None, :]                   # sin
    xr, xi = xt[0], xt[1]
    mr = (xr * oc - xi * osn).reshape(-1, n)     # (C, N)
    mi = (xr * osn + xi * oc).reshape(-1, n)
    g1 = (len(taps_d) - 1) // 2
    g2 = (len(taps_c) - 1) // 2
    yr = _conv1d_real(_conv1d_real(mr, taps_d, decim, (g1, g1)), taps_c, 1,
                      (g2, g2))
    yi = _conv1d_real(_conv1d_real(mi, taps_d, decim, (g1, g1)), taps_c, 1,
                      (g2, g2))
    return _demod_from_pair(yr, yi, sps, k, threshold, crc=crc)


def _as_pair(x, device) -> torch.Tensor:
    """Complex (N,) or real (2, N) input -> (2, N) f32 on `device`."""
    x = torch.as_tensor(x, device=device)
    if x.is_complex():
        return torch.stack([x.real, x.imag]).to(torch.float32)
    return x.to(torch.float32)


class RealPairFrontend(CandidateStage):
    """Grid-locked, complex-free multicarrier frontend (the reference's
    `RealPairFrontend`), for the carriers of its state's mixer table:
    forward(x) -> RealPairResult, or RealPairDecodeResult with
    num_candidates > 0.  x is (N,) complex or (2, N) f32, N a multiple of
    the table's period."""

    def __init__(self, state: StagedState, *, sps: int, device,
                 num_candidates: int = 0, threshold: float = 0.80):
        if state.table is None:
            raise ValueError("RealPairFrontend needs a state with a mixer "
                             "table (staged_state(..., table=True))")
        super().__init__(sps=sps, device=device,
                         num_candidates=num_candidates, threshold=threshold)
        self.decim = state.decim
        device = torch.device(device)
        for name in ("table", "taps_d", "taps_c"):
            self.register_buffer(name, torch.as_tensor(
                getattr(state, name), dtype=torch.float32, device=device))

    @classmethod
    def from_offsets(cls, offsets_hz, config: ReceiverConfig | None = None,
                     **kwargs) -> "RealPairFrontend":
        cfg = config or ReceiverConfig()
        return cls(staged_state(offsets_hz, cfg, table=True),
                   sps=cfg.ref_samples_per_symbol, **kwargs)

    def forward(self, x):
        return _realpair_block(_as_pair(x, self.device), self.table,
                               self.taps_d, self.taps_c, self.decim,
                               self.sps, self.num_candidates, self.threshold,
                               (self.crc_a, self.crc_c0))


class RealPairPfbFrontend(CandidateStage):
    """Complex-free full-band frontend (the reference's
    `RealPairPfbFrontend`): `pfb.pfb_channelize_realpair` over all
    fs / 25 kHz channels (96 at 2.4 MS/s), then the demod tail; row c is
    the channel at `channel_offsets_hz()[c]` (fftfreq order)."""

    def __init__(self, config: ReceiverConfig | None = None, *, device,
                 num_candidates: int = 0, threshold: float = 0.80,
                 taps_per_branch: int = 8):
        cfg = config or ReceiverConfig()
        super().__init__(sps=cfg.ref_samples_per_symbol, device=device,
                         num_candidates=num_candidates, threshold=threshold)
        self.sample_rate_hz = cfg.sample_rate_hz
        self.num_channels = int(round(cfg.sample_rate_hz / 25e3))
        self.decim = cfg.decimation_factor
        self.register_buffer("taps", torch.as_tensor(
            pfb.design_prototype(self.num_channels, taps_per_branch),
            dtype=torch.float32, device=torch.device(device)))

    def channel_offsets_hz(self) -> np.ndarray:
        return pfb.channel_offsets_hz(self.num_channels, self.sample_rate_hz)

    def forward(self, x):
        y = pfb.pfb_channelize_realpair(_as_pair(x, self.device),
                                        self.num_channels, self.decim,
                                        self.taps)
        return _demod_from_pair(y[0], y[1], self.sps, self.num_candidates,
                                self.threshold, crc=(self.crc_a, self.crc_c0))
