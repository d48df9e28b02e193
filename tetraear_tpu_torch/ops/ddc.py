"""Digital down-conversion: the frequency shift (port of
`tetraear_tpu.ops.ddc`)."""

from __future__ import annotations

import math

import numpy as np
import torch


def frequency_shift(x: torch.Tensor, freq_offset_hz, sample_rate_hz: float,
                    start_index: int = 0) -> torch.Tensor:
    """x * exp(-j 2pi f t), t = (f32(start) + f32(i)) / f32(fs), each step
    rounded to f32 as the reference's: the phase is f32(f32(-2pi) f) t.
    fs divides as a device tensor: PyTorch multiplies by the reciprocal
    of a host scalar divisor on the card.  complex64 out."""
    dev = x.device
    n = x.shape[-1]
    t = (torch.arange(n, dtype=torch.float32, device=dev)
         + float(np.float32(start_index)))
    # device scalars made by a fill, not copied from the host (a copy from
    # pageable memory waits for the stream)
    t = t / torch.full((), sample_rate_hz, dtype=torch.float32, device=dev)
    f = torch.full((), float(freq_offset_hz), dtype=torch.float32, device=dev)
    ph = (f * (-2.0 * math.pi)) * t
    osc = torch.complex(torch.cos(ph), torch.sin(ph))
    return (x.to(torch.complex64) * osc).to(torch.complex64)
