"""Codec input-block builders: 690-short (1380-byte) blocks for the ETSI
channel decoder (header 0x6B21 + soft bits at the Write_Tetra_File
positions).

Three builders, mirroring the reference's three call sites:

* :func:`block_from_symbols` — ui/modern.py:2309-2417 (slot symbols -> +/-127
  soft bits in the 4 block ranges).
* :func:`block_from_hard_bits` — continuous_capture.py:101-124 and
  tools/rtl_auto_capture.py:51-90 (first 432 frame bits as +/-127).
* :func:`block_from_soft_llrs` — an addition of this package: real soft demod
  outputs (ops/dqpsk.demodulate_soft) scaled into the codec's soft-bit
  range, preserving confidence instead of hard +/-127.
"""

from __future__ import annotations

import struct
from typing import Optional

import numpy as np

from tetraear_tpu_torch import constants as C


def _place_soft_bits(soft_bits) -> bytes:
    """Place up to 432 int soft bits into the 690-short layout and pack."""
    block = [0] * C.CODEC_BLOCK_SHORTS
    block[0] = C.CODEC_FRAME_HEADER
    idx = 0
    for lo, hi in C.CODEC_BIT_RANGES:
        for i in range(lo, hi):
            if idx < len(soft_bits):
                block[i] = int(soft_bits[idx])
                idx += 1
    return struct.pack(f"<{C.CODEC_BLOCK_SHORTS}h", *block)


def block_from_hard_bits(bits, magnitude: int = C.CODEC_SOFT_BIT_MAG) -> bytes:
    """First 432 bits as hard +/-magnitude soft bits
    (continuous_capture.py:103-124)."""
    bits = np.asarray(bits)
    soft = [magnitude if int(b) else -magnitude for b in bits[:432]]
    return _place_soft_bits(soft)


def block_from_symbols(frame: dict, demodulated_symbols,
                       samples_per_symbol: int) -> Optional[bytes]:
    """Voice-slot extraction from the symbol stream
    (ui/modern.py:2309-2417), including its documented quirks:

    * bit->symbol position conversion divides by 3 (modern.py:2323);
    * symbol values are cast with int() — note the reference feeds this the
      *complex* processor.symbols stream (modern.py:2031-2034), so the cast
      truncates/raises depending on numpy version; meaningful output needs
      integer dibits.
    """
    try:
        pos = frame.get("position")
        if pos is None:
            return None
        symbol_pos = pos // 3
        demodulated_symbols = np.asarray(demodulated_symbols)
        if symbol_pos + C.SYMBOLS_PER_SLOT > len(demodulated_symbols):
            return None
        slot = demodulated_symbols[symbol_pos:symbol_pos + C.SYMBOLS_PER_SLOT]

        soft = []
        for i in range(108):
            if i >= len(slot):
                break
            sym = int(slot[i])
            soft.append(16384 if (sym >> 1) & 1 else -16384)
            soft.append(16384 if sym & 1 else -16384)
        for i in range(119, 227):
            if i >= len(slot):
                break
            sym = int(slot[i])
            soft.append(16384 if (sym >> 1) & 1 else -16384)
            soft.append(16384 if sym & 1 else -16384)

        scaled = [max(-127, min(127, int((sb / 16384.0) * 127))) for sb in soft]
        return _place_soft_bits(scaled)
    except Exception:
        return None


def block_from_soft_llrs(llrs) -> bytes:
    """Soft path: per-bit LLR-ish values in [-1, 1] from
    ops/dqpsk.demodulate_soft -> scaled int soft bits.  Gives the ETSI
    channel decoder real confidence information."""
    llrs = np.asarray(llrs, dtype=np.float32).reshape(-1)[:432]
    scaled = np.clip(np.round(llrs * C.CODEC_SOFT_BIT_MAG),
                     -C.CODEC_SOFT_BIT_MAG, C.CODEC_SOFT_BIT_MAG).astype(int)
    return _place_soft_bits(list(scaled))


def block_from_acelp_heuristic(voice_bits) -> Optional[bytes]:
    """The reference's parameter-mapping fallback (ui/modern.py:2144-2201):
    interprets 4x108-bit subframes as quantized ACELP parameters with
    stronger +/-300 bit quantization."""
    voice_bits = np.asarray(voice_bits)
    if len(voice_bits) < 432:
        return None
    block = [0] * C.CODEC_BLOCK_SHORTS
    block[0] = C.CODEC_FRAME_HEADER
    for subframe in range(4):
        offset = subframe * 108
        sub = voice_bits[offset:offset + 108]
        base = 1 + subframe * 172
        if len(sub) < 108:
            continue
        energy = int(sum(int(b) << i for i, b in enumerate(sub[0:6])))
        block[base] = int((energy / 63.0) * 1000) - 500
        pitch = int(sum(int(b) << i for i, b in enumerate(sub[6:13])))
        block[base + 1] = int((pitch / 127.0) * 200) + 20
        gain = int(sum(int(b) << i for i, b in enumerate(sub[13:16])))
        block[base + 2] = int((gain / 7.0) * 150)
        for i, bit in enumerate(sub[16:108]):
            if base + 3 + i < C.CODEC_BLOCK_SHORTS:
                block[base + 3 + i] = 300 if bit else -300
    return struct.pack(f"<{C.CODEC_BLOCK_SHORTS}h", *block)


def validate_block(frame_data: bytes) -> bool:
    """Size + header check (voice.py:90-99)."""
    if len(frame_data) != C.CODEC_BLOCK_BYTES:
        return False
    return struct.unpack("<H", frame_data[0:2])[0] == C.CODEC_FRAME_HEADER


def bits_from_tet_block(block: bytes) -> np.ndarray:
    """690-short .tet block -> the 432 coded bits (sign > 0 <=> 1) in
    over-the-air order — the inverse of _place_soft_bits' layout."""
    words = np.frombuffer(block, dtype="<i2")
    out = np.zeros(432, np.uint8)
    idx = 0
    for lo, hi in C.CODEC_BIT_RANGES:
        n = hi - lo
        out[idx:idx + n] = (words[lo:hi] > 0).astype(np.uint8)
        idx += n
    return out
