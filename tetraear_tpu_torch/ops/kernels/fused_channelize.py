"""K5: the per-carrier mixer fused into the decimating FIR, and its plain
version.

    y[c, m] = sum_k taps[k] * x[mD - G + k] * exp(-j ph_c[mD - G + k])

  K5  `fused_channelize`: replaces
      `tetraear_tpu/ops/pallas/fused_channelize.py:_kernel` (entry point
      `fused_channelize`, the reference's drop-in for
      `channelizer.channelize`); source `csrc/fused_channelize.cu`.  The
      source's note says what bounds it on the card and why.

The plain version is the staged pair `channelizer.mix_to_baseband` +
`fir.fir_decimate`.  The wrapper launches the kernel for CUDA tensors and
runs the plain version for CPU tensors; there is no other fallback.
`LAUNCHES` counts the kernel's launches.  Unlike the TPU kernel, K5
takes any N, any offsets and any odd tap count L and decimation D whose
tile window fits its registers (`tile_outputs`: L up to ~3000 taps; the
frontends' L = 12 D + 1 up to D = 192, 46 MS/s), and returns ceil(N/D)
outputs, as `channelize` does.

The kernel reduces the f32 mixer phase exactly in fp64 by quarter turns
against the split HALF_PI_HI + HALF_PI_LO of pi/2, with TWO_OVER_PI
(the source's note); the wrapper passes these very constants, and the
CPU tests hold a numpy mirror of the reduction on them.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

LAUNCHES = {"fused_channelize": 0}

HALF_PI_HI = 1.5707963267948966          # fl64(pi / 2)
HALF_PI_LO = 6.123233995736766e-17       # fl64(pi / 2 - HALF_PI_HI)
TWO_OVER_PI = 0.6366197723675814         # fl64(2 / pi)

THREADS, OUT_PER_THREAD, GROUP = 256, 4, 4   # block, FIR tile, carriers
MAX_WINDOW = THREADS * 12                    # window samples of a tile
TWO_BLOCKS_SMEM = 113 * 1024                 # a block's, two to an SM
SPECIALISED = (121, 10)   # (L, D) of the staged frontend at 2.4 MS/s


def window_smem_bytes(tile_m: int, num_taps: int, decim: int) -> int:
    """Shared memory of a K5 block: GROUP carriers' mixed windows, D
    rows of T - 1 + ceil(L / D) columns and a pad column every 4, plus
    one spare slot (complex64)."""
    cols = tile_m - 1 + -(-num_taps // decim)
    return 8 * (GROUP * decim * (cols + (cols - 1) // OUT_PER_THREAD) + 1)


def tile_outputs(num_taps: int, decim: int) -> int:
    """Outputs per carrier of one K5 tile (fused_channelize.cu): 256 at
    the specialised (L, D), else the largest multiple of 4 up to 256
    whose window, D x (T - 1 + ceil(L / D)) samples, fits the block's
    registers, and whose mixed windows leave room for two blocks on an
    SM where any does.  Raises ValueError where not even 4 outputs fit."""
    if (num_taps, decim) == SPECIALISED:
        return 256
    cols = -(-num_taps // decim)
    fits = [t for t in range(THREADS * OUT_PER_THREAD // GROUP, 3, -4)
            if decim * (t - 1 + cols) <= MAX_WINDOW]
    if not fits:
        raise ValueError(f"fused_channelize: L = {num_taps} taps at D = "
                         f"{decim} leave no tile of {OUT_PER_THREAD} outputs "
                         f"within a window of {MAX_WINDOW} samples")
    return next((t for t in fits
                 if window_smem_bytes(t, num_taps, decim) <= TWO_BLOCKS_SMEM),
                fits[0])


def fused_channelize_plain(x: torch.Tensor, offsets_hz, sample_rate_hz: float,
                           decim: int, taps, start_index: int = 0
                           ) -> torch.Tensor:
    """mix_to_baseband + fir_decimate: (N,) complex64 -> (C, ceil(N/D))."""
    from tetraear_tpu_torch.ops.channelizer import mix_to_baseband
    from tetraear_tpu_torch.ops.fir import fir_decimate
    mixed = mix_to_baseband(x, offsets_hz, sample_rate_hz, start_index)
    return fir_decimate(mixed, taps, decim)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    from tetraear_tpu_torch.ops.kernels import build
    lib, _report = build("fused_channelize")
    fn = lib.tetra_fused_channelize
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_float, ctypes.c_double, ctypes.c_double,
        ctypes.c_double, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]
    lib.tetra_cuda_error_string.restype = ctypes.c_char_p
    lib.tetra_cuda_error_string.argtypes = [ctypes.c_int]
    return lib


def fused_channelize(x: torch.Tensor, offsets_hz, sample_rate_hz: float,
                     decim: int, taps, start_index: int = 0) -> torch.Tensor:
    """K5, drop-in for `channelizer.channelize` with explicit taps (the
    reference's `fused_channelize` signature): x (N,) complex64, offsets
    (C,), taps (L,) with L odd -> (C, ceil(N/decim)) complex64."""
    if x.device.type == "cpu":
        return fused_channelize_plain(x, offsets_hz, sample_rate_hz, decim,
                                      taps, start_index)
    if x.device.type != "cuda":
        raise ValueError(f"fused_channelize: x on {x.device}; the kernel "
                         "takes a CUDA tensor")
    if x.dtype != torch.complex64 or x.dim() != 1 or not x.is_contiguous():
        raise ValueError("fused_channelize: x must be a contiguous 1-D "
                         f"complex64 tensor, got {x.dtype} {tuple(x.shape)}")
    offs = torch.as_tensor(offsets_hz, dtype=torch.float32,
                           device=x.device).contiguous()
    taps = torch.as_tensor(taps, dtype=torch.float32,
                           device=x.device).contiguous()
    if offs.dim() != 1 or taps.dim() != 1 or len(taps) % 2 == 0:
        raise ValueError("fused_channelize: offsets must be (C,) and taps "
                         f"(L,) with L odd, got {tuple(offs.shape)} and "
                         f"{tuple(taps.shape)}")
    if decim < 1 or len(offs) < 1:
        raise ValueError(f"fused_channelize: decim = {decim} and "
                         f"{len(offs)} carriers; both must be >= 1")
    tile_m = tile_outputs(len(taps), decim)
    n = x.shape[0]
    m_out = -(-n // decim)
    out = torch.empty((len(offs), m_out), dtype=torch.complex64,
                      device=x.device)
    if m_out == 0:
        return out
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.tetra_fused_channelize(
            x.data_ptr(), n, offs.data_ptr(), len(offs), taps.data_ptr(),
            len(taps), decim, tile_m, float(np.float32(start_index)),
            float(np.float32(sample_rate_hz)), HALF_PI_HI, HALF_PI_LO,
            TWO_OVER_PI, out.data_ptr(), m_out, stream)
    if err:
        raise RuntimeError("fused_channelize: launch failed: "
                           + lib.tetra_cuda_error_string(err).decode())
    LAUNCHES["fused_channelize"] += 1
    return out
