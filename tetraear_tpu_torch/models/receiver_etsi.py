"""The `etsi` quality receiver (port of `tetraear_tpu.models.receiver_etsi`).

Decimate 2.4 MS/s -> 240 kHz with the ref-compat FIR, shift, resample
x3/10 with an RRC matched filter onto 72 kHz = exactly 4 samples per
18 kHz symbol, energy-max timing over the 4 phases, soft pi/4-DQPSK
demod (maximum-margin hard decisions plus per-bit soft values) for the
channel decode (ops/channel_coding.py).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from tetraear_tpu_torch.config import ReceiverConfig
from tetraear_tpu_torch.models.receiver import as_iq
from tetraear_tpu_torch.ops import ddc, dqpsk, fir, resample, sync, timing


class EtsiDemodResult(NamedTuple):
    symbols_iq: torch.Tensor    # (M,) complex64 at symbol rate (padded)
    hard_symbols: torch.Tensor  # (M-1,) uint8, etsi quantizer
    soft_bits: torch.Tensor     # (M-1, 2) f32 in [-1, 1]
    bits: torch.Tensor          # (2(M-1),) uint8
    sync_corr: torch.Tensor     # dense best-of-TS1/TS2 scores
    count: torch.Tensor         # () int32
    best_phase: torch.Tensor    # () int32 timing phase in [0, sps)


def _etsi_block(iq: torch.Tensor, freq_offset: float, cfg: ReceiverConfig,
                taps_d: torch.Tensor, taps_r: np.ndarray) -> EtsiDemodResult:
    """The etsi chain for one block.  The shift runs at every offset, 0
    included, as the reference's jitted block does (its offset arrives as
    a traced scalar)."""
    decim = cfg.decimation_factor
    y = fir.fir_decimate(iq, taps_d, decim) if decim > 1 else iq
    y = ddc.frequency_shift(y, freq_offset, cfg.intermediate_rate_hz)
    z = resample.rational_resample(y, 3, 10, taps_r)
    ts = timing.best_phase_pick(z, cfg.etsi_sps, step=1)
    soft = dqpsk.demodulate_soft(ts.symbols)
    bits = dqpsk.symbols_to_bits(soft.symbols)
    corr = sync.best_correlation(bits)
    return EtsiDemodResult(ts.symbols, soft.symbols, soft.soft_bits, bits,
                           corr, ts.count, ts.best_phase)


class EtsiReceiver(nn.Module):
    """etsi-profile demodulator on an explicit device."""

    def __init__(self, config: ReceiverConfig | None = None, *, device):
        super().__init__()
        base = config or ReceiverConfig()
        if base.profile != "etsi":
            base = dataclasses.replace(base, profile="etsi")
        self.config = base
        self.device = torch.device(device)
        self.register_buffer("taps_d", torch.as_tensor(
            fir.design_decimation_fir(base.decimation_factor,
                                      base.decim_fir_taps_per_phase),
            device=self.device))
        # 240 kHz -> 72 kHz with RRC matched filtering (L = 3, M = 10)
        self.taps_r = resample.design_rrc_resampler(
            3, 10, base.etsi_sps, base.rrc_alpha, base.rrc_span_symbols)

    def forward(self, iq, freq_offset: float = 0.0) -> EtsiDemodResult:
        return _etsi_block(as_iq(iq, self.device), float(freq_offset),
                           self.config, self.taps_d, self.taps_r)

    def process(self, iq, freq_offset: float = 0.0) -> np.ndarray:
        """SignalProcessor-compatible hard-symbol surface."""
        res = self(iq, freq_offset)
        count = int(res.count)
        if count < 2:
            return np.array([], dtype=np.uint8)
        return res.hard_symbols.cpu().numpy()[:count - 1]
