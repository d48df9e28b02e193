"""The single-carrier receiver (port of `tetraear_tpu.models.receiver`):
one block of complex IQ -> symbol-rate samples, dibits, bits and dense
sync scores, on the module's device.  The host decoder
(`tetraear_tpu_torch.core.decoder.TetraDecoder`) then applies the
protocol logic.

* `Frontend` — the block pipeline of the `ref-exact` and `ref-compat`
  profiles as an nn.Module.  The reference caches one jitted program per
  (length, shift); the port holds the ref-compat taps as buffers, which
  serve every length.
* `SignalProcessor` — the reference's drop-in receiver API: `process`,
  `process_full`, the `.symbols` side channel and the single stages;
  profile "etsi" dispatches to `receiver_etsi.EtsiReceiver`.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from tetraear_tpu import constants as C
from tetraear_tpu.config import ReceiverConfig
from tetraear_tpu_torch.ops import ddc, dqpsk, fir, iir, sync, timing


class DemodResult(NamedTuple):
    """Device outputs for one IQ block (fixed shapes, padded)."""
    symbols_iq: torch.Tensor    # (M,) complex64 symbol-rate samples
    hard_symbols: torch.Tensor  # (M-1,) uint8 dibits
    bits: torch.Tensor          # (2(M-1),) uint8
    sync_corr: torch.Tensor     # (2(M-1)-21,) f32 best of TS1/TS2
    count: torch.Tensor         # () int32 valid symbol samples
    best_phase: torch.Tensor    # () int32


def channel_cutoff(cfg: ReceiverConfig) -> float:
    """The channel filter's cutoff as a fraction of the intermediate
    rate's Nyquist frequency, as the reference computes it."""
    return (cfg.channel_bandwidth_hz / 2) / (cfg.intermediate_rate_hz / 2)


def _frontend_block(iq: torch.Tensor, freq_offset: float,
                    cfg: ReceiverConfig, apply_shift: bool,
                    taps_d=None, taps_c=None) -> DemodResult:
    """The single-carrier chain for one block: ref-exact runs the IIR
    decimate and Butterworth filtfilt, ref-compat the FIRs `taps_d` and
    `taps_c` of matched squared magnitude."""
    decim = cfg.decimation_factor
    inter_rate = cfg.intermediate_rate_hz
    exact = cfg.profile == "ref-exact"
    if decim > 1:
        y = (iir.decimate_exact(iq, decim) if exact
             else fir.fir_decimate(iq, taps_d, decim))
    else:
        y = iq
    if apply_shift:
        y = ddc.frequency_shift(y, freq_offset, inter_rate)
    y = (iir.butter_filtfilt_exact(y, channel_cutoff(cfg)) if exact
         else fir.fir_filter_same(y, taps_c))
    ts = timing.best_phase_pick(y, cfg.ref_samples_per_symbol)
    hard = dqpsk.demodulate_hard(ts.symbols, profile="ref")
    bits = dqpsk.symbols_to_bits(hard)
    corr = sync.best_correlation(bits)
    return DemodResult(ts.symbols, hard, bits, corr, ts.count, ts.best_phase)


def as_iq(iq, device: torch.device) -> torch.Tensor:
    """IQ (numpy or tensor) as a complex64 tensor on `device`."""
    return torch.as_tensor(iq, device=device).to(torch.complex64)


class Frontend(nn.Module):
    """Block demodulator of the `ref-exact` / `ref-compat` profiles."""

    def __init__(self, config: ReceiverConfig | None = None, *, device):
        super().__init__()
        self.config = config or ReceiverConfig()
        self.device = torch.device(device)
        cfg = self.config
        fir_taps = cfg.profile != "ref-exact"
        self.register_buffer("taps_d", torch.as_tensor(
            fir.design_decimation_fir(cfg.decimation_factor,
                                      cfg.decim_fir_taps_per_phase),
            device=self.device) if fir_taps else None)
        self.register_buffer("taps_c", torch.as_tensor(
            fir.design_channel_fir(cfg.channel_fir_taps,
                                   channel_cutoff(cfg)),
            device=self.device) if fir_taps else None)

    def forward(self, iq, freq_offset: float = 0.0) -> DemodResult:
        return _frontend_block(as_iq(iq, self.device), float(freq_offset),
                               self.config, freq_offset != 0.0,
                               self.taps_d, self.taps_c)


class SignalProcessor:
    """The reference SignalProcessor's API on the port:
    `SignalProcessor(sample_rate, config, device=...).process(samples,
    freq_offset)` -> uint8 dibits 0..3, with `.symbols` the complex
    symbol-rate samples afterwards; the single stages `resample`,
    `filter_signal`, `frequency_shift`, `extract_symbols` and
    `demodulate_dqpsk` take and return numpy arrays, computed on the
    processor's device."""

    def __init__(self, sample_rate: float = C.DEFAULT_SAMPLE_RATE_HZ,
                 config: ReceiverConfig | None = None, *, device):
        self.sample_rate = sample_rate
        base = config or ReceiverConfig()
        if base.sample_rate_hz != sample_rate:
            base = dataclasses.replace(base, sample_rate_hz=sample_rate)
        self.config = base
        self.device = torch.device(device)
        self.symbol_rate = C.SYMBOL_RATE_HZ
        self.samples_per_symbol = int(sample_rate / self.symbol_rate)
        self.symbols: np.ndarray | None = None
        if base.profile == "etsi":
            from tetraear_tpu_torch.models.receiver_etsi import EtsiReceiver
            self._frontend = EtsiReceiver(base, device=self.device)
        else:
            self._frontend = Frontend(base, device=self.device)

    # -- full pipeline ------------------------------------------------------
    def process(self, samples, freq_offset: float = 0.0) -> np.ndarray:
        samples = np.asarray(samples)
        if samples.size == 0:
            self.symbols = np.array([], dtype=complex)
            return np.array([], dtype=np.uint8)
        res = self._frontend(samples, freq_offset)
        count = int(res.count)
        self.symbols = res.symbols_iq[:count].cpu().numpy()
        if count < 2:
            return np.array([], dtype=np.uint8)
        return res.hard_symbols.cpu().numpy()[:count - 1]

    def process_full(self, samples, freq_offset: float = 0.0):
        """The full device result (bits, sync scores, soft bits for etsi)."""
        return self._frontend(samples, freq_offset)

    # -- single stages ------------------------------------------------------
    def _put(self, samples) -> torch.Tensor:
        return as_iq(np.asarray(samples, np.complex64), self.device)

    def resample(self, samples, target_rate):
        """FFT resample to target_rate (scipy.signal.resample's spectrum
        cut or zero-fill)."""
        samples = np.asarray(samples)
        new_n = int(len(samples) * target_rate / self.sample_rate)
        spec = torch.fft.fft(self._put(samples))
        return _fft_resample(spec, len(samples), new_n).cpu().numpy()

    def filter_signal(self, samples, bandwidth=C.CHANNEL_BANDWIDTH_HZ,
                      sample_rate=None):
        fs = sample_rate if sample_rate is not None else self.sample_rate
        samples = np.asarray(samples)
        if samples.size == 0:
            return samples
        cutoff = (bandwidth / 2) / (fs / 2)
        x = self._put(samples)
        if self.config.profile == "ref-exact":
            return iir.butter_filtfilt_exact(x, cutoff).cpu().numpy()
        taps = fir.design_channel_fir(self.config.channel_fir_taps, cutoff)
        return fir.fir_filter_same(x, taps).cpu().numpy()

    def frequency_shift(self, samples, freq_offset, sample_rate=None):
        fs = sample_rate if sample_rate is not None else self.sample_rate
        return ddc.frequency_shift(self._put(samples), freq_offset,
                                   fs).cpu().numpy()

    def extract_symbols(self, samples, sample_rate=None):
        fs = sample_rate if sample_rate is not None else self.sample_rate
        samples = np.asarray(samples)
        if samples.size == 0:
            return np.array([], dtype=complex)
        ts = timing.best_phase_pick(self._put(samples),
                                    int(fs / self.symbol_rate))
        return ts.symbols[:int(ts.count)].cpu().numpy()

    def demodulate_dqpsk(self, samples) -> np.ndarray:
        samples = np.asarray(samples)
        if samples.size < 2:
            return np.array([], dtype=np.uint8)
        return dqpsk.demodulate_hard(self._put(samples),
                                     profile="ref").cpu().numpy()


def _fft_resample(spec: torch.Tensor, n: int, new_n: int) -> torch.Tensor:
    """scipy.signal.resample-style spectral resampling of a complex
    signal's spectrum `spec` (length n) to new_n samples."""
    if new_n == n:
        return torch.fft.ifft(spec)
    k = min(n, new_n)
    half = k // 2
    out = torch.zeros(new_n, dtype=spec.dtype, device=spec.device)
    out[:half + (k % 2)] = spec[:half + (k % 2)]
    out[new_n - half:] = spec[n - half:]
    return torch.fft.ifft(out) * (new_n / n)
