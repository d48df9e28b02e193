"""Frozen copy of the golden MAC-RESOURCE slot and the TETRA constants the
benchmark's traffic and reference need.  Nothing here imports the
program: the yardstick must not move when the program does.

Copied from tetraear_tpu_torch/utils/synth.py (make_mac_resource_frame_bits
:95, _golden_slot_from_head :139, _gf2_solve :177, _uint_to_bits :91),
tetraear_tpu_torch/ops/crc.py (crc16_bits :26, crc16_bits_arr :38,
_crc_matrix :45) and tetraear_tpu_torch/constants.py (TS1 :42, TS2 :44,
SYNC_DISCONTINUOUS_DOWNLINK :50, TRAINING_SEQUENCES_14 :61, the burst
layout :70-73, the sync and CRC constants :34-36, :87-89).
"""

from __future__ import annotations

import functools

import numpy as np

TS1 = np.array([1, 1, 0, 1, 0, 0, 0, 0, 1, 1, 1, 0, 1, 0, 0, 1, 1, 1, 0, 1,
                0, 0], np.uint8)
TS2 = np.array([0, 1, 1, 1, 1, 0, 1, 0, 0, 1, 0, 0, 0, 0, 1, 1, 0, 1, 1, 1,
                0, 0], np.uint8)
# the discontinuous-downlink sync word (constants.py:50)
SYNC_DISCONTINUOUS = np.array([0, 0, 1, 1, 1, 0, 1, 0, 0, 1, 0, 0, 0, 0, 1,
                               1, 0, 1, 0, 0, 1, 1], np.uint8)
TRAINING_14 = np.array([0, 1, 1, 0, 1, 0, 0, 1, 1, 1, 0, 0, 1, 1], np.uint8)
BITS_PER_SLOT = 510
SYMBOLS_PER_SLOT = 255
SYNC_LEN_BITS = 22
SYNC_TO_FRAME_START_BITS = 216     # a slot starts 216 bits before its sync
SYNC_SKIP_BITS = 250               # the host's greedy walk skips this far
BURST_BLOCK1 = (0, 108)
BURST_BLOCK2 = (122, 230)
CRC16_POLY = 0x1021
CRC16_INIT = 0xFFFF
CRC_SOFT_ERROR_BUDGET = 2


def _uint_to_bits(val: int, n: int) -> np.ndarray:
    return np.array([(val >> (n - 1 - i)) & 1 for i in range(n)], np.uint8)


def crc16_bits(bits) -> int:
    """CRC-16 (poly 0x1021, init 0xFFFF), one shift per message bit."""
    crc = CRC16_INIT
    for bit in np.asarray(bits).astype(np.int64) & 1:
        crc ^= int(bit) << 15
        if crc & 0x8000:
            crc = ((crc << 1) ^ CRC16_POLY) & 0xFFFF
        else:
            crc = (crc << 1) & 0xFFFF
    return crc


def crc16_bits_arr(bits) -> np.ndarray:
    crc = crc16_bits(bits)
    return np.array([(crc >> i) & 1 for i in range(15, -1, -1)], np.uint8)


@functools.lru_cache(maxsize=4)
def crc_matrix(m: int) -> tuple:
    """(A, c0): crc(x) = (A @ x) % 2 ^ c0 for messages of m bits."""
    dep = np.zeros((16, m), np.uint8)
    const = np.array([(CRC16_INIT >> (15 - s)) & 1 for s in range(16)],
                     np.uint8)
    poly = np.array([(CRC16_POLY >> (15 - s)) & 1 for s in range(16)],
                    np.uint8)
    for i in range(m):
        fb_dep = dep[0].copy()
        fb_dep[i] ^= 1
        fb_const = const[0]
        new_dep = np.zeros_like(dep)
        new_dep[:15] = dep[1:]
        new_const = np.zeros_like(const)
        new_const[:15] = const[1:]
        new_dep ^= poly[:, None] * fb_dep[None, :]
        new_const ^= poly * fb_const
        dep, const = new_dep, new_const
    return dep, const


def _gf2_solve(a: np.ndarray, b: np.ndarray):
    """Solve a x = b over GF(2); None if inconsistent."""
    a = (a.copy() & 1).astype(np.uint8)
    b = (b.copy() & 1).astype(np.uint8)
    n_rows, n_cols = a.shape
    x = np.zeros(n_cols, np.uint8)
    pivots = []
    row = 0
    for col in range(n_cols):
        sel = next((r for r in range(row, n_rows) if a[r, col]), None)
        if sel is None:
            continue
        if sel != row:
            a[[row, sel]] = a[[sel, row]]
            b[[row, sel]] = b[[sel, row]]
        for r in range(n_rows):
            if r != row and a[r, col]:
                a[r] ^= a[row]
                b[r] ^= b[row]
        pivots.append((row, col))
        row += 1
        if row == n_rows:
            break
    if any(b[r] for r in range(row, n_rows)):
        return None
    for r, c in pivots:
        x[c] = b[r]
    return x


def mac_resource_slot(payload: bytes, seed: int,
                      address: int = 0x1234) -> np.ndarray:
    """A 510-bit slot carrying a clear MAC-RESOURCE PDU with `payload` as
    its SDS text, TS1 at bits [216, 238), and 14 filler bits solved over
    GF(2) so that the CRC the sync overlay forces is the true CRC: the
    slot passes the soft-CRC gate and parses on the host."""
    head = np.concatenate([
        [0, 0, 0, 0, 0], _uint_to_bits(address, 24),
        _uint_to_bits(len(payload), 6),
        np.unpackbits(np.frombuffer(payload, np.uint8))]).astype(np.uint8)
    if head.size > 186:
        raise ValueError("payload leaves no filler bits to solve the CRC")
    rng = np.random.default_rng(seed)
    data = np.concatenate([head, rng.integers(0, 2, 200 - head.size)
                           .astype(np.uint8)])
    free = np.arange(186, 200)
    a, _ = crc_matrix(200)
    base = data.copy()
    base[free] = 0
    resid = (crc16_bits_arr(base)[2:16] ^ TS1[:14]) & 1
    x = _gf2_solve(a[2:16][:, free] & 1, resid)
    if x is None:
        raise RuntimeError("CRC constraint system singular for this seed")
    data = base
    data[free] = x
    full = np.concatenate([data, crc16_bits_arr(data)])
    slot = rng.integers(0, 2, BITS_PER_SLOT).astype(np.uint8)
    slot[0:108] = full[0:108]
    slot[108:122] = TRAINING_14
    slot[122:230] = full[108:216]
    slot[216:238] = TS1
    return slot
