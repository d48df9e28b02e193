"""Key management and the common-key brute-force tables.

`TetraKeyManager` — ALG:ID:HEX key-file format (crypto.py:271-411).
`COMMON_KEYS` — the reference's built-in weak/default key lists
(decoder.py:36-98), reproduced byte-for-byte: these are behavioral constants
of the brute-force path.  NOTE several entries have *invalid lengths* for
their algorithm; the reference counts them as tried and lets the decryptor's
key validation reject them — keep them (quirk).
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional, Tuple

logger = logging.getLogger(__name__)

COMMON_KEYS: Dict[str, List[bytes]] = {
    "TEA1": [
        bytes.fromhex("00000000000000000000"),        # all zeros
        bytes.fromhex("FFFFFFFFFFFFFFFFFFFFFFFF"),    # all ones (12 B - invalid, kept)
        bytes.fromhex("0123456789ABCDEF0123"),        # sequential
        bytes.fromhex("FEDCBA9876543210FEDC"),        # reverse sequential
        bytes.fromhex("1111111111111111111111"),      # (11 B - invalid, kept)
        bytes.fromhex("AAAAAAAAAAAAAAAAAAAA"),
        bytes.fromhex("5555555555555555555555"),      # (11 B - invalid, kept)
        bytes.fromhex("0001020304050607080910"),      # (11 B - invalid, kept)
        bytes.fromhex("1234567890ABCDEF1234"),
        bytes.fromhex("DEADBEEFCAFEBABEFACE"),
        bytes.fromhex("A0B1C2D3E4F506172839"),
        bytes.fromhex("112233445566778899AA"),
        bytes.fromhex("0F0F0F0F0F0F0F0F0F0F"),
    ],
    "TEA2": [
        bytes.fromhex("00000000000000000000000000000000"),
        bytes.fromhex("FFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFF"),
        bytes.fromhex("0123456789ABCDEF0123456789ABCDEF"),
        bytes.fromhex("FEDCBA9876543210FEDCBA9876543210"),
        bytes.fromhex("11111111111111111111111111111111"),
        bytes.fromhex("AAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAA"),
        bytes.fromhex("55555555555555555555555555555555"),
        bytes.fromhex("000102030405060708091011121314151617"),  # 18 B - invalid, kept
        bytes.fromhex("1234567890ABCDEF1234567890ABCDEF"),
        bytes.fromhex("DEADBEEFCAFEBABEDEADBEEFCAFEBABE"),
        bytes.fromhex("A0B1C2D3E4F5061728394A5B6C7D8E9F"),
        bytes.fromhex("1122334455667788990011223344556677"),    # 17 B - invalid, kept
    ],
    "TEA3": [
        bytes.fromhex("00000000000000000000000000000000"),
        bytes.fromhex("FFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFF"),
    ],
    "TEA4": [
        bytes.fromhex("00000000000000000000000000000000"),
        bytes.fromhex("FFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFF"),
    ],
}


def parse_user_keys(keys: List[str]) -> List[Tuple[str, bytes]]:
    """Hex key strings -> (algorithm, key) pairs (decoder.py:101-138).

    10-byte keys -> TEA1; 16-byte keys are cross-registered for
    TEA2/TEA3/TEA4; 32-byte keys fall back to their first 16 bytes.
    """
    out: List[Tuple[str, bytes]] = []
    for key_str in keys:
        try:
            cleaned = key_str.replace(" ", "").replace(":", "").replace("-", "")
            key_bytes = bytes.fromhex(cleaned)
            if len(key_bytes) == 10:
                out.append(("TEA1", key_bytes))
            elif len(key_bytes) == 16:
                out.append(("TEA2", key_bytes))
                out.append(("TEA3", key_bytes))
                out.append(("TEA4", key_bytes))
            elif len(key_bytes) == 32:
                logger.warning("256-bit key provided; using first 128 bits "
                               "for TEA2/TEA3/TEA4 attempts")
                k = key_bytes[:16]
                out.append(("TEA2", k))
                out.append(("TEA3", k))
                out.append(("TEA4", k))
            else:
                logger.warning("Invalid key length: %d bytes (expected 10 or 16)",
                               len(key_bytes))
        except Exception as e:
            logger.error("Failed to parse key '%s': %s", key_str, e)
    return out


class TetraKeyManager:
    """ALG:ID:HEX key file store (crypto.py:271-411)."""

    def __init__(self):
        self.keys: Dict[str, Dict[str, bytes]] = {}

    def load_key_file(self, filepath: str) -> None:
        try:
            with open(filepath, "r") as f:
                for line_num, line in enumerate(f, 1):
                    line = line.strip()
                    if not line or line.startswith("#"):
                        continue
                    try:
                        parts = line.split(":")
                        if len(parts) != 3:
                            logger.warning("Invalid key format at line %d: %s",
                                           line_num, line)
                            continue
                        algorithm, key_id, hex_key = parts
                        algorithm = algorithm.upper()
                        key_bytes = bytes.fromhex(hex_key)
                        self.keys.setdefault(algorithm, {})[key_id] = key_bytes
                        logger.info("Loaded %s key %s", algorithm, key_id)
                    except ValueError as e:
                        logger.warning("Error parsing key at line %d: %s",
                                       line_num, e)
        except FileNotFoundError:
            logger.error("Key file not found: %s", filepath)
            raise
        except Exception as e:
            logger.error("Error loading key file: %s", e)
            raise

    def get_key(self, algorithm: str, key_id: str = "0") -> Optional[bytes]:
        algorithm = algorithm.upper()
        return self.keys.get(algorithm, {}).get(key_id)

    def add_key(self, algorithm: str, key_id: str, key: bytes) -> None:
        self.keys.setdefault(algorithm.upper(), {})[key_id] = key

    def has_key(self, algorithm: str, key_id: str = "0") -> bool:
        algorithm = algorithm.upper()
        return algorithm in self.keys and key_id in self.keys[algorithm]
