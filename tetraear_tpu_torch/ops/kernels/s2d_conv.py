"""K1 — the composite space-to-depth conv — and its plain version.

    out[c, w] = sum_{i < 2D, a < Lp} K2[c, i, a] * X2[w + a, i]

X2 is the (N, 2) re/im view of x, left-padded by L-1-gc samples and
viewed as (W, 2D); K2 is the (C2, 2D, Lp) s2d kernel of
`ops.fused.s2d_kernel`; the output is the un-derotated (C2, ceil(N/D))
channel pair in block row order [re.., im..].  This replaces the Pallas
kernel `tetraear_tpu/ops/pallas/s2d_conv.py:_kernel` (entry point
`pallas_s2d_conv_wk`); the CUDA source is `csrc/s2d_conv.cu`.

`s2d_conv` launches K1 for a CUDA tensor and runs the plain version for
a CPU tensor; there is no other fallback.  `LAUNCHES` counts K1 launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

LAUNCHES = 0


def s2d_conv_plain(x: torch.Tensor, kernel_s2d: torch.Tensor, gc: int,
                   L: int, decim: int, *, bf16: bool = False) -> torch.Tensor:
    """F.conv1d over the free (W, 2D) view of the zero-padded (N, 2)
    input, in f32 (TF32 off).  bf16=True rounds both operands to bf16
    first and still accumulates in f32 — K1's bf16 numbers up to the
    order of the sums.  x: (N,) complex64 -> (C2, ceil(N/D)) f32."""
    n = x.shape[-1]
    m_out = -(-n // decim)
    lp = kernel_s2d.shape[-1]
    pad_l = L - 1 - gc
    # cover the conv's read window and the left-padded input; surplus
    # outputs are sliced off (tetraear_tpu/ops/fused.py:_s2d_conv)
    total = max((m_out + lp - 1) * decim, -(-(pad_l + n) // decim) * decim)
    xpad = F.pad(torch.view_as_real(x), (0, 0, pad_l, total - pad_l - n))
    x2 = xpad.reshape(1, total // decim, 2 * decim).transpose(1, 2)
    k = kernel_s2d
    if bf16:
        x2 = x2.to(torch.bfloat16).float()
        k = k.to(torch.bfloat16).float()
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        out = F.conv1d(x2, k)
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    return out[0, :, :m_out]


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    from tetraear_tpu_torch.ops.kernels import build
    lib, _report = build("s2d_conv")
    lib.tetra_s2d_conv.restype = ctypes.c_int
    lib.tetra_s2d_conv.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    lib.tetra_cuda_error_string.restype = ctypes.c_char_p
    lib.tetra_cuda_error_string.argtypes = [ctypes.c_int]
    return lib


def s2d_conv(x: torch.Tensor, kernel_s2d: torch.Tensor, gc: int, L: int,
             decim: int, *, bf16: bool = False) -> torch.Tensor:
    """K1: x (N,) complex64 + s2d kernel (C2, 2D, Lp) f32 -> (C2,
    ceil(N/D)) f32.  bf16=True: bf16 operands, f32 accumulation."""
    global LAUNCHES
    if x.device.type == "cpu" and kernel_s2d.device.type == "cpu":
        return s2d_conv_plain(x, kernel_s2d, gc, L, decim, bf16=bf16)
    if x.device.type != "cuda" or kernel_s2d.device != x.device:
        raise ValueError(f"s2d_conv: x on {x.device} and kernel on "
                         f"{kernel_s2d.device}; K1 takes both on one card")
    if x.dtype != torch.complex64 or x.dim() != 1 or not x.is_contiguous():
        raise ValueError(f"s2d_conv: x must be a contiguous 1-D complex64 "
                         f"tensor, got {x.dtype} {tuple(x.shape)}")
    if (kernel_s2d.dtype != torch.float32 or kernel_s2d.dim() != 3
            or kernel_s2d.shape[1] != 2 * decim):
        raise ValueError(f"s2d_conv: kernel must be (C2, {2 * decim}, Lp) "
                         f"float32, got {kernel_s2d.dtype} "
                         f"{tuple(kernel_s2d.shape)}")
    c2, ich, lp = kernel_s2d.shape
    pad_l = L - 1 - gc
    if pad_l < 0 or L > lp * decim:
        raise ValueError(f"s2d_conv: need 0 <= L-1-gc and L <= Lp*D, got "
                         f"L={L} gc={gc} Lp={lp} D={decim}")
    n = x.shape[0]
    m_out = -(-n // decim)
    out = torch.empty((c2, m_out), dtype=torch.float32, device=x.device)
    if m_out == 0:
        return out
    # K1's weight layout: tap-major (Lp, 2D, C2), output rows innermost,
    # so a block stages its row group's weights with coalesced loads
    k_taps = kernel_s2d.permute(2, 1, 0).contiguous()
    xf = torch.view_as_real(x)
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.tetra_s2d_conv(xf.data_ptr(), 2 * n, k_taps.data_ptr(),
                                 out.data_ptr(), c2, ich, lp, 2 * pad_l,
                                 m_out, int(bf16), stream)
    if err:
        raise RuntimeError("s2d_conv: K1 launch failed: "
                           + lib.tetra_cuda_error_string(err).decode())
    LAUNCHES += 1
    return out
