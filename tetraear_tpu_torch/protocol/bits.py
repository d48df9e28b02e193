"""Bit-array helpers (host side).

The reference uses the third-party ``bitstring`` package; this module provides
the small subset of semantics the protocol layer needs, implemented on plain
``numpy`` uint8 arrays:

* ``bits_to_bytes`` matches ``BitArray(bits).tobytes()``: MSB-first packing,
  zero-padded at the *end* to a byte boundary (core/protocol.py:442).
* ``bits_to_uint`` matches ``BitArray(bits).uint`` (big-endian bit order).
* ``bits_to_int`` matches ``BitArray(bits).int`` (two's complement).
* ``bytes_to_bits`` is the MSB-first inverse used by the decrypt scorer
  (core/decoder.py:753-757).
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "as_bit_array",
    "bits_to_bytes",
    "bytes_to_bits",
    "bits_to_uint",
    "bits_to_int",
    "bits_to_binstr",
    "symbols_to_bit_pairs",
    "pack_fields",
    "BitCursor",
]


def as_bit_array(bits) -> np.ndarray:
    """Coerce a python/numpy sequence of 0/1 values to a uint8 array."""
    arr = np.asarray(bits)
    if arr.dtype != np.uint8:
        arr = arr.astype(np.uint8)
    return arr & 1


def bits_to_bytes(bits) -> bytes:
    """Pack bits MSB-first into bytes, zero-padding the tail."""
    arr = as_bit_array(bits)
    if arr.size == 0:
        return b""
    pad = (-arr.size) % 8
    if pad:
        arr = np.concatenate([arr, np.zeros(pad, dtype=np.uint8)])
    return np.packbits(arr).tobytes()


def bytes_to_bits(data: bytes) -> np.ndarray:
    """Unpack bytes MSB-first into a uint8 bit array."""
    if not data:
        return np.zeros(0, dtype=np.uint8)
    return np.unpackbits(np.frombuffer(data, dtype=np.uint8))


def bits_to_uint(bits) -> int:
    """Interpret bits as a big-endian unsigned integer."""
    val = 0
    for b in as_bit_array(bits):
        val = (val << 1) | int(b)
    return val


def bits_to_int(bits) -> int:
    """Interpret bits as a big-endian two's-complement signed integer."""
    arr = as_bit_array(bits)
    if arr.size == 0:
        return 0
    val = bits_to_uint(arr)
    if arr[0]:
        val -= 1 << arr.size
    return val


def bits_to_binstr(bits) -> str:
    """Render bits as a '0101...' string (matches BitArray.bin)."""
    return "".join("1" if b else "0" for b in as_bit_array(bits))


def pack_fields(pairs) -> np.ndarray:
    """[(value, width), ...] -> uint8 bit array, each field MSB-first.

    The layer-3 codecs (protocol/{mac,mle,cmce,mm}.py) and the broadcast
    PDUs share this; values are masked to their width.
    """
    out = []
    for value, width in pairs:
        v = int(value) & ((1 << width) - 1)
        out.extend((v >> (width - 1 - i)) & 1 for i in range(width))
    return np.asarray(out, dtype=np.uint8)


class BitCursor:
    """Sequential big-endian bit reader over a 0/1 array.

    ``take`` past the end raises ``ValueError`` — layer-3 parsers rely on
    that to reject truncated/garbage PDUs instead of reading zeros.
    """

    def __init__(self, bits):
        self.bits = as_bit_array(bits)
        self.pos = 0

    @property
    def remaining(self) -> int:
        return int(self.bits.size - self.pos)

    def take(self, width: int) -> int:
        if width > self.remaining:
            raise ValueError(
                f"bit underrun: need {width}, have {self.remaining}")
        v = 0
        for b in self.bits[self.pos:self.pos + width]:
            v = (v << 1) | int(b)
        self.pos += width
        return v

    def take_bits(self, width: int) -> np.ndarray:
        if width > self.remaining:
            raise ValueError(
                f"bit underrun: need {width}, have {self.remaining}")
        out = self.bits[self.pos:self.pos + width]
        self.pos += width
        return out


def symbols_to_bit_pairs(symbols) -> np.ndarray:
    """Expand 0..3 dibit symbols to a bit stream, MSB of each pair first.

    Matches protocol.py:210-214 / decoder.py:167.
    """
    syms = np.asarray(symbols).astype(np.int64) & 3
    out = np.empty(syms.size * 2, dtype=np.uint8)
    out[0::2] = (syms >> 1) & 1
    out[1::2] = syms & 1
    return out
