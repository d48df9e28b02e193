"""TEA-variant block decryption (behavioral parity with
tetraear/core/crypto.py:25-268).

The real TETRA TEA1-TEA4 algorithms are proprietary; like the reference,
these are TEA-shaped 32-round Feistel stand-ins whose exact arithmetic the
`ref-compat` profile must reproduce bit-for-bit (the decrypt *scoring* path
depends on the exact output bytes):

* TEA1: 80-bit key (10 bytes), key words selected by sum-derived indices.
* TEA2: 128-bit key, standard-TEA-shaped round function.
* TEA3/TEA4: alias TEA2 (reference crypto.py:165-195).

ECB and CBC modes over 8-byte blocks.  A C++ native fast path for the
brute-force loop lives in crypto/native.py; this module is the reference
implementation and fallback.
"""

from __future__ import annotations

import struct
from typing import Optional

_DELTA = 0x9E3779B9
_MASK = 0xFFFFFFFF


class TEADecryptor:
    KEY_LENGTHS = {"TEA1": 80, "TEA2": 128, "TEA3": 128, "TEA4": 128}

    def __init__(self, key: bytes, algorithm: str = "TEA1"):
        self.algorithm = algorithm.upper()
        self.key = key
        self._validate_key()

    def _validate_key(self) -> None:
        expected = self.KEY_LENGTHS.get(self.algorithm)
        if expected is None:
            raise ValueError(f"Unknown algorithm: {self.algorithm}")
        if len(self.key) * 8 != expected:
            raise ValueError(
                f"Key length mismatch for {self.algorithm}: "
                f"expected {expected} bits, got {len(self.key) * 8} bits")

    # -- block primitives ---------------------------------------------------
    def _tea1_decrypt_block(self, block: bytes) -> bytes:
        """crypto.py:88-126: 80-bit-key variant.  Key words are big-endian
        uint16s; the round uses sum-derived 2-bit indices into them."""
        if len(block) != 8:
            raise ValueError("TEA1 block must be 8 bytes")
        kw = [struct.unpack(">H", self.key[i:i + 2])[0] for i in range(0, 10, 2)]
        v0, v1 = struct.unpack(">II", block)
        s = _DELTA * 32  # unmasked python int, as the reference keeps it
        for _ in range(32):
            v1 = (v1 - ((((v0 << 4) ^ (v0 >> 5) ^ s) + v0)
                        ^ (kw[(s >> 11) & 3] + s))) & _MASK
            s -= _DELTA
            v0 = (v0 - ((((v1 << 4) ^ (v1 >> 5) ^ s) + v1)
                        ^ (kw[s & 3] + s))) & _MASK
        return struct.pack(">II", v0, v1)

    def _tea2_decrypt_block(self, block: bytes) -> bytes:
        """crypto.py:128-163: standard-TEA-shaped with 128-bit key."""
        if len(block) != 8:
            raise ValueError("TEA2 block must be 8 bytes")
        k0, k1, k2, k3 = struct.unpack(">IIII", self.key)
        v0, v1 = struct.unpack(">II", block)
        s = _DELTA * 32
        for _ in range(32):
            v1 = (v1 - ((((v0 << 4) + k2) ^ (v0 + s) ^ ((v0 >> 5) + k3)))) & _MASK
            s -= _DELTA
            v0 = (v0 - ((((v1 << 4) + k0) ^ (v1 + s) ^ ((v1 >> 5) + k1)))) & _MASK
        return struct.pack(">II", v0, v1)

    def _tea3_decrypt_block(self, block: bytes) -> bytes:
        return self._tea2_decrypt_block(block)

    def _tea4_decrypt_block(self, block: bytes) -> bytes:
        return self._tea2_decrypt_block(block)

    def decrypt_block(self, block: bytes) -> bytes:
        if self.algorithm == "TEA1":
            return self._tea1_decrypt_block(block)
        if self.algorithm == "TEA2":
            return self._tea2_decrypt_block(block)
        if self.algorithm == "TEA3":
            return self._tea3_decrypt_block(block)
        if self.algorithm == "TEA4":
            return self._tea4_decrypt_block(block)
        raise ValueError(f"Unsupported algorithm: {self.algorithm}")

    # -- modes --------------------------------------------------------------
    def decrypt(self, data: bytes, iv: Optional[bytes] = None) -> bytes:
        """ECB when iv is None, else CBC (crypto.py:221-268)."""
        if len(data) % 8 != 0:
            raise ValueError("Data length must be multiple of 8 bytes")
        if iv is None:
            return b"".join(self.decrypt_block(data[i:i + 8])
                            for i in range(0, len(data), 8))
        if len(iv) != 8:
            raise ValueError("IV must be 8 bytes")
        out = b""
        prev = iv
        for i in range(0, len(data), 8):
            block = data[i:i + 8]
            dec = self.decrypt_block(block)
            out += bytes(a ^ b for a, b in zip(dec, prev))
            prev = block
        return out


class TEAEncryptor:
    """Exact inverse of TEADecryptor — the TX direction the reference never
    had (it is receive-only; its crypto.py:25 implements decrypt only).

    Needed by the etsi downlink transmitter to produce encrypted-payload
    test traffic whose decryption through the reference-parity brute-force
    path is meaningful.  Inverts the *reference's* quirky round structures
    verbatim (unmasked running sum, sum decrement between half-rounds),
    so decrypt(encrypt(x)) == x bit-for-bit for every algorithm.
    """

    KEY_LENGTHS = TEADecryptor.KEY_LENGTHS

    def __init__(self, key: bytes, algorithm: str = "TEA1"):
        self.algorithm = algorithm.upper()
        self.key = key
        # share validation semantics
        TEADecryptor(key, algorithm)

    def _tea1_encrypt_block(self, block: bytes) -> bytes:
        kw = [struct.unpack(">H", self.key[i:i + 2])[0]
              for i in range(0, 10, 2)]
        v0, v1 = struct.unpack(">II", block)
        s = 0
        for _ in range(32):
            v0 = (v0 + ((((v1 << 4) ^ (v1 >> 5) ^ s) + v1)
                        ^ (kw[s & 3] + s))) & _MASK
            s += _DELTA
            v1 = (v1 + ((((v0 << 4) ^ (v0 >> 5) ^ s) + v0)
                        ^ (kw[(s >> 11) & 3] + s))) & _MASK
        return struct.pack(">II", v0, v1)

    def _tea2_encrypt_block(self, block: bytes) -> bytes:
        k0, k1, k2, k3 = struct.unpack(">IIII", self.key)
        v0, v1 = struct.unpack(">II", block)
        s = 0
        for _ in range(32):
            v0 = (v0 + (((v1 << 4) + k0) ^ (v1 + s)
                        ^ ((v1 >> 5) + k1))) & _MASK
            s += _DELTA
            v1 = (v1 + (((v0 << 4) + k2) ^ (v0 + s)
                        ^ ((v0 >> 5) + k3))) & _MASK
        return struct.pack(">II", v0, v1)

    def encrypt_block(self, block: bytes) -> bytes:
        if len(block) != 8:
            raise ValueError("block must be 8 bytes")
        if self.algorithm == "TEA1":
            return self._tea1_encrypt_block(block)
        return self._tea2_encrypt_block(block)      # TEA2/3/4 share rounds

    def encrypt(self, data: bytes, iv: Optional[bytes] = None) -> bytes:
        """ECB when iv is None, else CBC matching TEADecryptor.decrypt."""
        if len(data) % 8 != 0:
            raise ValueError("Data length must be multiple of 8 bytes")
        if iv is None:
            return b"".join(self.encrypt_block(data[i:i + 8])
                            for i in range(0, len(data), 8))
        if len(iv) != 8:
            raise ValueError("IV must be 8 bytes")
        out = b""
        prev = iv
        for i in range(0, len(data), 8):
            ct = self.encrypt_block(
                bytes(a ^ b for a, b in zip(data[i:i + 8], prev)))
            out += ct
            prev = ct
        return out
