"""ctypes loader for the native TEA brute-force engine (native/teacrypt.cpp).

Builds the shared library into build/native/ on first use if a toolchain
is available (utils/native_dsp.build_host_library); every
entry point degrades to the pure-Python implementation (crypto/tea.py) when
the library is missing, so behavior is identical either way — the native
path only removes the per-round Python interpreter cost from the decrypt
brute-force loop (decoder.py:683-783 analogue).
"""

from __future__ import annotations

import ctypes
import logging
from typing import List, Optional, Sequence, Tuple

from tetraear_tpu_torch.utils.native_dsp import build_host_library

logger = logging.getLogger(__name__)

_lib: Optional[ctypes.CDLL] = None
_load_attempted = False

_ALG_IDS = {"TEA1": 1, "TEA2": 2, "TEA3": 3, "TEA4": 4}
_EXPECTED_LEN = {"TEA1": 10, "TEA2": 16, "TEA3": 16, "TEA4": 16}


def get_lib() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native library; None when unavailable."""
    global _lib, _load_attempted
    if _lib is not None or _load_attempted:
        return _lib
    _load_attempted = True
    lib_path = build_host_library("teacrypt")
    if lib_path is None:
        logger.info("native teacrypt unavailable; using pure-Python TEA")
        return None
    try:
        lib = ctypes.CDLL(str(lib_path))
        lib.tea_bruteforce.restype = ctypes.c_int
        lib.tea_bruteforce.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_char_p, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
        ]
        lib.tea1_decrypt_ecb.restype = ctypes.c_int
        lib.tea1_decrypt_ecb.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                         ctypes.c_int,
                                         ctypes.POINTER(ctypes.c_uint8)]
        lib.tea2_decrypt_ecb.restype = ctypes.c_int
        lib.tea2_decrypt_ecb.argtypes = lib.tea1_decrypt_ecb.argtypes
        lib.tea_basic_score.restype = ctypes.c_int32
        lib.tea_basic_score.argtypes = [ctypes.c_char_p, ctypes.c_int]
        _lib = lib
        logger.debug("native teacrypt loaded from %s", lib_path)
    except Exception as e:
        logger.debug("native teacrypt load failed: %s", e)
        _lib = None
    return _lib


def available() -> bool:
    return get_lib() is not None


def decrypt_ecb(key: bytes, algorithm: str, data: bytes) -> Optional[bytes]:
    """Native single-key ECB decrypt; None -> caller should use Python path."""
    lib = get_lib()
    if lib is None:
        return None
    if len(key) != _EXPECTED_LEN.get(algorithm.upper(), -1) or len(data) % 8:
        return None
    out = (ctypes.c_uint8 * len(data))()
    fn = lib.tea1_decrypt_ecb if algorithm.upper() == "TEA1" \
        else lib.tea2_decrypt_ecb
    if fn(key, data, len(data), out) != 0:
        return None
    return bytes(out)


def bruteforce(keys: Sequence[Tuple[bytes, str]], data: bytes
               ) -> Optional[List[Optional[bytes]]]:
    """Decrypt `data` under every (key, algorithm) pair in one native call.

    Returns a list aligned with `keys`: plaintext bytes, or None where the
    key length is invalid for its algorithm (mirroring the ValueError the
    Python TEADecryptor raises).  Returns None when the library is absent.
    """
    lib = get_lib()
    if lib is None or len(data) % 8 != 0 or not keys:
        return None
    key_blob = b"".join(k for k, _ in keys)
    key_lens = (ctypes.c_int32 * len(keys))(*[len(k) for k, _ in keys])
    algs = (ctypes.c_int32 * len(keys))(
        *[_ALG_IDS.get(a.upper(), 2) for _, a in keys])
    out_plain = (ctypes.c_uint8 * (len(keys) * len(data)))()
    out_status = (ctypes.c_int32 * len(keys))()
    out_scores = (ctypes.c_int32 * len(keys))()
    rc = lib.tea_bruteforce(key_blob, key_lens, len(keys), algs, data,
                            len(data), out_plain, out_status, out_scores)
    if rc != 0:
        return None
    raw = bytes(out_plain)
    n = len(data)
    return [None if out_status[i] else raw[i * n:(i + 1) * n]
            for i in range(len(keys))]
