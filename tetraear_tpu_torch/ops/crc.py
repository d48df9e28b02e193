"""CRC-16-CCITT as a GF(2) affine map (port of `tetraear_tpu.ops.crc`).

For a fixed message length M, crc(bits) = (A @ bits) mod 2 XOR c0 with A
a 16 x M binary matrix.  `_crc_matrix` builds (A, c0) with numpy;
`crc16_batch` takes the product on the tensor's device as an f32 matmul
(CUDA has no int32 matmul) and then the parity: every sum is an integer
<= M (<= 200 here), exact in f32 — and in TF32, whose 10-bit mantissa
holds 0 and 1 exactly while the sum accumulates in f32.

The host oracles `crc16_bits`, `crc16_bits_arr` and `soft_crc_check_host`
(numpy) serve the host protocol code (protocol/parser.py, utils/synth.py).
`soft_crc_check_host` takes the native engine (utils/native_dsp) when it
is built, as the reference's does; its verdicts are the numpy oracle's.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from tetraear_tpu_torch import constants as C


def crc16_bits(bits) -> int:
    """Exact reference CRC: one shift per message bit."""
    crc = C.CRC16_INIT
    for bit in np.asarray(bits).astype(np.int64) & 1:
        crc ^= int(bit) << 15
        if crc & 0x8000:
            crc = ((crc << 1) ^ C.CRC16_POLY) & 0xFFFF
        else:
            crc = (crc << 1) & 0xFFFF
    return crc


def crc16_bits_arr(bits) -> np.ndarray:
    """CRC as a 16-element MSB-first bit array."""
    crc = crc16_bits(bits)
    return np.array([(crc >> i) & 1 for i in range(15, -1, -1)], dtype=np.uint8)


@functools.lru_cache(maxsize=32)
def _crc_matrix(m: int) -> tuple[np.ndarray, np.ndarray]:
    """(A, c0): crc_bits(x) = (A @ x) % 2 ^ c0 for messages of length m,
    built by stepping the CRC's linear recurrence once per message bit."""
    state_dep = np.zeros((16, m), dtype=np.uint8)
    state_const = np.array([(C.CRC16_INIT >> (15 - s)) & 1 for s in range(16)],
                           dtype=np.uint8)
    poly_bits = np.array([(C.CRC16_POLY >> (15 - s)) & 1 for s in range(16)],
                         dtype=np.uint8)
    for i in range(m):
        # feedback bit = state_bit0 XOR input_i
        fb_dep = state_dep[0].copy()
        fb_dep[i] ^= 1
        fb_const = state_const[0]
        # shift left, inject feedback times polynomial
        new_dep = np.zeros_like(state_dep)
        new_dep[:15] = state_dep[1:]
        new_const = np.zeros_like(state_const)
        new_const[:15] = state_const[1:]
        new_dep ^= poly_bits[:, None] * fb_dep[None, :]
        new_const ^= poly_bits * fb_const
        state_dep, state_const = new_dep, new_const
    return state_dep, state_const


def soft_crc_check_host(data_bits) -> bool:
    """The reference's soft acceptance for one frame: not all-0 or all-1,
    and at most CRC_SOFT_ERROR_BUDGET bit errors on the forward or the
    reversed-payload CRC.  The native engine where it is built, else the
    numpy oracle `soft_crc_check_numpy`."""
    from tetraear_tpu_torch.utils import native_dsp
    verdict = native_dsp.soft_crc_check(data_bits, C.CRC_SOFT_ERROR_BUDGET)
    if verdict is not None:
        return verdict
    return soft_crc_check_numpy(data_bits)


def soft_crc_check_numpy(data_bits) -> bool:
    """soft_crc_check_host on the GF(2) CRC matrix, in numpy."""
    bits = np.asarray(data_bits).astype(np.uint8) & 1
    if bits.size < 16:
        return False
    ones = int(bits.sum())
    if ones == 0 or ones == bits.size:
        return False
    payload, received = bits[:-16], bits[-16:]
    a, c0 = _crc_matrix(payload.size)
    a = a.astype(np.int64)
    for p in (payload, payload[::-1]):
        crc = (a @ p.astype(np.int64)) % 2 ^ c0
        if int(np.sum(crc != received)) <= C.CRC_SOFT_ERROR_BUDGET:
            return True
    return False


def crc_tables(m: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(A as (16, m) f32, c0 as (16,) int32) on `device` for crc16_batch."""
    a, c0 = _crc_matrix(m)
    return (torch.as_tensor(a, dtype=torch.float32, device=device),
            torch.as_tensor(c0, dtype=torch.int32, device=device))


def crc16_batch(bits: torch.Tensor, a: torch.Tensor,
                c0: torch.Tensor) -> torch.Tensor:
    """Batched CRC over the last axis: (..., M) in {0, 1} -> (..., 16)
    uint8 CRC bits, MSB first.  (a, c0) from crc_tables(M, device)."""
    acc = torch.matmul(bits.to(torch.float32), a.t())
    return ((acc.to(torch.int32) & 1) ^ c0).to(torch.uint8)


def soft_crc_check_batch(data_bits: torch.Tensor, a: torch.Tensor,
                         c0: torch.Tensor) -> torch.Tensor:
    """Vectorized soft CRC over frames: (..., D) with D >= 16, payload =
    [:-16], received CRC = [-16:]; (a, c0) from crc_tables(D - 16).
    Returns (...,) bool."""
    d = data_bits.shape[-1]
    if d < 16:
        return torch.zeros(data_bits.shape[:-1], dtype=torch.bool,
                           device=data_bits.device)
    payload = data_bits[..., :-16]
    received = data_bits[..., -16:]
    ones = data_bits.to(torch.int32).sum(dim=-1)
    nondegenerate = (ones != 0) & (ones != d)
    fwd = crc16_batch(payload, a, c0)
    rev = crc16_batch(payload.flip(-1), a, c0)
    err_f = (fwd != received).sum(dim=-1)
    err_r = (rev != received).sum(dim=-1)
    ok = ((err_f <= C.CRC_SOFT_ERROR_BUDGET)
          | (err_r <= C.CRC_SOFT_ERROR_BUDGET))
    return nondegenerate & ok
