"""ctypes loader for the native host-DSP engine (native/hostdsp.cpp).

These calls remove the Python interpreter cost from the host runtime's
hot bit/byte loops: the per-frame soft-CRC gate
(ops/crc.soft_crc_check_host), SC16-Q11 capture conversion and the FM
discriminator.  The library is compiled from the repo's
native/hostdsp.cpp into build/native/ (never into native/) on first use;
every entry point returns None when no C++ compiler or library is at
hand, and its caller then takes the pure-Python/NumPy path: the host's
behaviour is identical either way.  `build_host_library` also builds
native/teacrypt.cpp for crypto/native.py.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

import numpy as np

logger = logging.getLogger(__name__)

_REPO = Path(__file__).resolve().parents[2]
NATIVE_SRC = _REPO / "native"
NATIVE_BUILD = _REPO / "build" / "native"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-Wall")

_lib: Optional[ctypes.CDLL] = None
_load_attempted = False


def build_host_library(name: str) -> Optional[Path]:
    """native/<name>.cpp compiled by the host's C++ compiler ($CXX, else
    g++) into build/native/lib<name>_<digest>.so, once per version of the
    source; None when there is no compiler or it refuses the source.
    Processes may build at once: each writes a temporary file and renames
    it into place."""
    src = NATIVE_SRC / f"{name}.cpp"
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not src.exists() or cxx is None:
        return None
    digest = hashlib.sha256(src.read_bytes() + " ".join(CXX_FLAGS).encode()
                            ).hexdigest()[:16]
    lib_path = NATIVE_BUILD / f"lib{name}_{digest}.so"
    if lib_path.exists():
        return lib_path
    try:
        NATIVE_BUILD.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=NATIVE_BUILD)
        os.close(fd)
    except OSError as e:
        logger.debug("native %s build error: %s", name, e)
        return None
    try:
        result = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, str(src)],
                                capture_output=True, timeout=120)
        ok = result.returncode == 0
        if not ok:
            logger.debug("native %s build failed: %s", name,
                         result.stderr.decode("utf-8", "ignore")[-400:])
    except (OSError, subprocess.SubprocessError) as e:
        logger.debug("native %s build error: %s", name, e)
        ok = False
    if not ok:
        os.unlink(tmp)
        return None
    os.replace(tmp, lib_path)
    return lib_path


def get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _load_attempted
    if _lib is not None or _load_attempted:
        return _lib
    _load_attempted = True
    lib_path = build_host_library("hostdsp")
    if lib_path is None:
        logger.info("native hostdsp unavailable; using NumPy fallbacks")
        return None
    try:
        lib = ctypes.CDLL(str(lib_path))
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.crc16_ccitt.restype = ctypes.c_uint16
        lib.crc16_ccitt.argtypes = [u8p, ctypes.c_long]
        lib.soft_crc_check.restype = ctypes.c_int
        lib.soft_crc_check.argtypes = [u8p, ctypes.c_long, ctypes.c_int]
        lib.soft_crc_check_batch.restype = None
        lib.soft_crc_check_batch.argtypes = [
            u8p, ctypes.c_long, ctypes.c_long, ctypes.c_int, u8p]
        lib.sc16q11_to_cf32.restype = None
        lib.sc16q11_to_cf32.argtypes = [
            ctypes.POINTER(ctypes.c_int16), ctypes.c_long,
            ctypes.POINTER(ctypes.c_float)]
        lib.fm_discriminator.restype = None
        lib.fm_discriminator.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_long,
            ctypes.POINTER(ctypes.c_float)]
        _lib = lib
    except OSError as e:
        logger.info("native hostdsp load failed: %s", e)
    return _lib


def _as_u8(bits) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(bits), dtype=np.uint8) & 1


def crc16_bits(bits) -> Optional[int]:
    """Native CRC-16-CCITT over a bit array; None when unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    arr = _as_u8(bits)
    return int(lib.crc16_ccitt(
        arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), arr.size))


def soft_crc_check(data_bits, budget: int) -> Optional[bool]:
    """Native reference _check_crc; None when unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    arr = _as_u8(data_bits)
    return bool(lib.soft_crc_check(
        arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), arr.size,
        budget))


def soft_crc_check_batch(frames, budget: int) -> Optional[np.ndarray]:
    """Native batched _check_crc over (F, D) frames; None if unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    arr = np.ascontiguousarray(np.asarray(frames), dtype=np.uint8) & 1
    f, d = arr.shape
    out = np.empty(f, np.uint8)
    lib.soft_crc_check_batch(
        arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), f, d, budget,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return out.astype(bool)


def sc16q11_to_cf32(raw: np.ndarray) -> Optional[np.ndarray]:
    """Interleaved int16 I/Q -> complex64 / 2048; None when unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    arr = np.ascontiguousarray(np.asarray(raw, np.int16))
    n_pairs = arr.size // 2
    out = np.empty(2 * n_pairs, np.float32)
    lib.sc16q11_to_cf32(
        arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)), n_pairs,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return out.view(np.complex64)


def fm_discriminator(iq: np.ndarray) -> Optional[np.ndarray]:
    """angle(x[1:] * conj(x[:-1])) / pi * 0.5; None when unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    arr = np.ascontiguousarray(np.asarray(iq, np.complex64))
    if arr.size < 2:
        return np.zeros(0, np.float32)
    out = np.empty(arr.size - 1, np.float32)
    lib.fm_discriminator(
        arr.view(np.float32).ctypes.data_as(
            ctypes.POINTER(ctypes.c_float)), arr.size,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return out
