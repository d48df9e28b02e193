"""pi/4-DQPSK differential demodulation (port of `tetraear_tpu.ops.dqpsk`):
the reference's phase bins on dphi = atan2(z) and the sector quantizers
on z = x[n] conj(x[n-1]) itself, the `etsi` profile's soft demod, and
dibit unpacking.

The reference bins (`quantize_phase_ref`) keep the reference receiver's
quirk: they are centred on {0, +-pi/2, pi}, not on the pi/4-DQPSK
transitions.  Every bin edge is an f32 comparison, as in the reference.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

# tan(3pi/8) and tan(pi/8), rounded to f32 as the reference's f32 math does
_T38 = float(np.float32(1.0 + np.sqrt(2.0)))
_T18 = float(np.float32(np.sqrt(2.0) - 1.0))
# bin edges -5pi/8, -3pi/8, 3pi/8, 5pi/8 and pi/2, rounded to f32
_B0, _B1, _B2, _B3 = (float(np.float32(k * math.pi / 8))
                      for k in (-5, -3, 3, 5))
_HALF_PI = float(np.float32(math.pi / 2))


def differential_phase(symbols: torch.Tensor) -> torch.Tensor:
    """dphi[n] = angle(x[n+1] conj(x[n])); length N-1 along the last axis."""
    z = symbols[..., 1:] * symbols[..., :-1].conj()
    return torch.atan2(z.imag, z.real)


def quantize_phase_ref(dphi: torch.Tensor) -> torch.Tensor:
    """Reference bins: [-5pi/8, -3pi/8) -> 2, [-3pi/8, 3pi/8) -> 0,
    [3pi/8, 5pi/8) -> 1, otherwise 3.  uint8."""
    sym = torch.full(dphi.shape, 3, dtype=torch.uint8, device=dphi.device)
    sym = torch.where((dphi >= _B0) & (dphi < _B1), 2, sym)
    sym = torch.where((dphi >= _B1) & (dphi < _B2), 0, sym)
    sym = torch.where((dphi >= _B2) & (dphi < _B3), 1, sym)
    return sym.to(torch.uint8)


def quantize_phase_etsi(dphi: torch.Tensor) -> torch.Tensor:
    """Maximum-margin quantizer: the sign of dphi gives the MSB, |dphi|
    against pi/2 the LSB.  uint8."""
    msb = (dphi < 0).to(torch.uint8)
    lsb = (dphi.abs() > _HALF_PI).to(torch.uint8)
    return msb * 2 + lsb


def demodulate_hard(symbols: torch.Tensor, profile: str = "ref"
                    ) -> torch.Tensor:
    """Complex symbol stream -> uint8 dibits (length N-1)."""
    dphi = differential_phase(symbols)
    if profile == "etsi":
        return quantize_phase_etsi(dphi)
    return quantize_phase_ref(dphi)


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


def quantize_z_etsi(zr: torch.Tensor, zi: torch.Tensor) -> torch.Tensor:
    """Maximum-margin quantizer on z: msb = zi < 0, lsb = zr < 0.  uint8."""
    return ((zi < 0).to(torch.uint8) * 2
            + (zr < 0).to(torch.uint8)).to(torch.uint8)


class SoftDemod(NamedTuple):
    symbols: torch.Tensor     # uint8 hard decisions (etsi quantizer)
    dphi: torch.Tensor        # f32 phase differences (radians)
    magnitude: torch.Tensor   # f32 |z|, a confidence proxy
    soft_bits: torch.Tensor   # (..., N-1, 2) f32 in [-1, 1], +1 == bit 1


def demodulate_soft(symbols: torch.Tensor) -> SoftDemod:
    """Soft-output demod of the `etsi` profile: the MSB's soft bit is
    -sin(dphi) (> 0 where dphi < 0, dibits 2 and 3), the LSB's -cos(dphi)
    (> 0 where |dphi| > pi/2, dibits 1 and 3)."""
    z = symbols[..., 1:] * symbols[..., :-1].conj()
    dphi = torch.atan2(z.imag, z.real)
    soft = torch.stack([-torch.sin(dphi), -torch.cos(dphi)], dim=-1)
    return SoftDemod(quantize_phase_etsi(dphi), dphi.to(torch.float32),
                     z.abs().to(torch.float32), soft.to(torch.float32))
