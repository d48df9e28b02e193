"""pi/4-DQPSK sector quantizer and dibit unpacking (port of
`tetraear_tpu.ops.dqpsk.quantize_z_ref` and `symbols_to_bits`)."""

from __future__ import annotations

import numpy as np
import torch

# tan(3pi/8) and tan(pi/8), rounded to f32 as the reference's f32 math does
_T38 = float(np.float32(1.0 + np.sqrt(2.0)))
_T18 = float(np.float32(np.sqrt(2.0) - 1.0))


def quantize_z_ref(zr: torch.Tensor, zi: torch.Tensor) -> torch.Tensor:
    """Reference-bin quantizer on z = x[n] conj(x[n-1]) by sector
    comparisons (no atan2):

        bin 0: zr > 0 and |zi| <= zr tan(3pi/8)
        bin 1: zi > 0 and |zr| <  zi tan(pi/8)
        bin 2: zi < 0 and |zr| < -zi tan(pi/8)
        bin 3: otherwise (z = 0 included)

    with precedence bin 0 > 1 > 2 > 3.  Returns uint8."""
    azr = zr.abs()
    azi = zi.abs()
    s0 = (zr > 0) & (azi <= zr * _T38)
    s1 = (zi > 0) & (azr < zi * _T18)
    s2 = (zi < 0) & (azr < -zi * _T18)
    sym = torch.full(zr.shape, 3, dtype=torch.uint8, device=zr.device)
    sym = torch.where(s2, 2, sym)
    sym = torch.where(s1, 1, sym)
    sym = torch.where(s0, 0, sym)
    return sym.to(torch.uint8)


def symbols_to_bits(symbols: torch.Tensor) -> torch.Tensor:
    """Dibits 0..3 -> interleaved bit stream, MSB first: (..., S) ->
    (..., 2S) uint8."""
    s = symbols.to(torch.int32) & 3
    bits = torch.stack([(s >> 1) & 1, s & 1], dim=-1)
    return bits.reshape(*s.shape[:-1], s.shape[-1] * 2).to(torch.uint8)
