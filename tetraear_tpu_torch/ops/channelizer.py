"""Multicarrier channelization (port of `tetraear_tpu.ops.channelizer`,
whose module imports jax): one wideband IQ stream -> C baseband carrier
streams by a per-carrier mixer and one shared decimating FIR.

`channelize` launches K5 (`ops.kernels.fused_channelize`, the mixer
fused into the FIR) for a CUDA tensor; for a CPU tensor it runs the
plain pair `mix_to_baseband` + `fir.fir_decimate`, which is also K5's
plain version.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from tetraear_tpu_torch.ops import fir


def carrier_grid(num_carriers: int, spacing_hz: float = 25_000.0,
                 center_offset_hz: float = 0.0) -> np.ndarray:
    """Symmetric grid of carrier offsets around the capture center.  An
    even count lands on odd multiples of spacing/2 (±12.5 kHz, ...)."""
    idx = np.arange(num_carriers) - (num_carriers - 1) / 2.0
    return (idx * spacing_hz + center_offset_hz).astype(np.float32)


def mixer_phase(offsets_hz: torch.Tensor, n: int, sample_rate_hz: float,
                start_index: int = 0) -> torch.Tensor:
    """(C, n) f32 mixer phase, op for op as the reference computes it:
    t = (f32(start) + f32(i)) / f32(fs), ph = f32(f32(-2pi) * f_c) * t,
    each step rounded to f32.  fs divides as a device tensor: PyTorch
    multiplies by the reciprocal of a host scalar divisor on the card."""
    dev = offsets_hz.device
    t = (torch.arange(n, dtype=torch.float32, device=dev)
         + float(np.float32(start_index)))
    t = t / torch.tensor(sample_rate_hz, dtype=torch.float32, device=dev)
    w = offsets_hz.to(torch.float32) * (-2.0 * math.pi)
    return w[:, None] * t[None, :]


def mix_to_baseband(x: torch.Tensor, offsets_hz, sample_rate_hz: float,
                    start_index: int = 0) -> torch.Tensor:
    """x: (N,) complex64; offsets_hz: (C,) -> (C, N) complex64 streams
    x * exp(-j 2pi f_c t), phase-continuous across blocks through
    `start_index` (the block's first sample index)."""
    offs = torch.as_tensor(offsets_hz, dtype=torch.float32, device=x.device)
    ph = mixer_phase(offs, x.shape[-1], sample_rate_hz, start_index)
    osc = torch.complex(torch.cos(ph), torch.sin(ph))
    return x[None, :] * osc


def channelize(x: torch.Tensor, offsets_hz, sample_rate_hz: float,
               decim: int, taps=None, start_index: int = 0) -> torch.Tensor:
    """Wideband (N,) complex64 -> (C, ceil(N/decim)) carrier basebands:
    K5 on a CUDA tensor, mix_to_baseband + fir_decimate on a CPU one."""
    from tetraear_tpu_torch.ops.kernels.fused_channelize import (
        fused_channelize)
    if taps is None:
        taps = fir.design_decimation_fir(decim)
    return fused_channelize(x, offsets_hz, sample_rate_hz, decim, taps,
                            start_index)
