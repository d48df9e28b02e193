"""TETRA scrambling, ETSI EN 300 392-2 section 8.2.5 (port of
`tetraear_tpu.ops.scramble`).

The sequence comes from a 32-bit LFSR with the TETRA polynomial's taps,
seeded with the 30-bit extended colour code (MCC 10 | MNC 14 | colour
code 6) behind two 1-bits; the BSCH uses colour code 0.  The sequence is
made on the host (numpy, cached) and XORed, or sign-flipped for soft
bits, on the tensor's device.  Descrambling is scrambling.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

# feedback taps of the degree-32 scrambler polynomial (1-indexed)
_TAPS = (32, 26, 23, 22, 16, 12, 11, 10, 8, 7, 5, 4, 2, 1)


def extended_colour_code(mcc: int, mnc: int, colour_code: int) -> int:
    """30-bit extended colour code: MCC(10) | MNC(14) | CC(6)."""
    return ((mcc & 0x3FF) << 20) | ((mnc & 0x3FFF) << 6) | (colour_code & 0x3F)


@functools.lru_cache(maxsize=256)
def scrambling_sequence(ecc30: int, length: int) -> np.ndarray:
    """`length` scrambling bits: LFSR state p[1..32] = [e1..e30, 1, 1],
    output p[32] each step, feedback the XOR of the tap positions."""
    state = [(ecc30 >> (29 - i)) & 1 for i in range(30)] + [1, 1]
    out = np.empty(length, dtype=np.uint8)
    for n in range(length):
        out[n] = state[31]
        fb = 0
        for t in _TAPS:
            fb ^= state[t - 1]
        state = [fb] + state[:31]
    return out


def scramble(bits: torch.Tensor, ecc30: int = 0) -> torch.Tensor:
    """bits (..., N) XOR the scrambling sequence; ecc30 = 0 gives the
    BSCH / broadcast sequence."""
    seq = torch.as_tensor(scrambling_sequence(ecc30, bits.shape[-1]),
                          device=bits.device)
    return (bits ^ seq.to(bits.dtype)).to(bits.dtype)


descramble = scramble


def scramble_soft(llrs: torch.Tensor, ecc30: int = 0) -> torch.Tensor:
    """Soft bits with their sign flipped where the sequence bit is 1."""
    seq = torch.as_tensor(
        scrambling_sequence(ecc30, llrs.shape[-1]).astype(np.float32),
        device=llrs.device)
    return llrs * (1.0 - 2.0 * seq)
