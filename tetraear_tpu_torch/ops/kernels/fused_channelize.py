"""K5: the per-carrier mixer fused into the decimating FIR, and its plain
version.

    y[c, m] = sum_k taps[k] * x[mD + G - k] * exp(-j ph_c[mD + G - k])

  K5  `fused_channelize`: replaces
      `tetraear_tpu/ops/pallas/fused_channelize.py:_kernel` (entry point
      `fused_channelize`, the reference's drop-in for
      `channelizer.channelize`); source `csrc/fused_channelize.cu`.  The
      source's note says what bounds it on the card and why.

The plain version is the staged pair `channelizer.mix_to_baseband` +
`fir.fir_decimate`.  The wrapper launches the kernel for CUDA tensors and
runs the plain version for CPU tensors; there is no other fallback.
`LAUNCHES` counts the kernel's launches.  Unlike the TPU kernel, K5
takes any N, any odd tap count and any offsets, and returns ceil(N/D)
outputs, as `channelize` does.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

LAUNCHES = {"fused_channelize": 0}


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
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.c_float, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]
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
            len(taps), decim, float(np.float32(start_index)),
            float(np.float32(sample_rate_hz)), out.data_ptr(), m_out, stream)
    if err:
        raise RuntimeError("fused_channelize: launch failed: "
                           + lib.tetra_cuda_error_string(err).decode())
    LAUNCHES["fused_channelize"] += 1
    return out
