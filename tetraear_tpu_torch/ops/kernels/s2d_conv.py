"""The composite space-to-depth conv — kernels K1, K1-of, K3 and K4 —
and their plain versions.

    out[c, w] = sum_{i < 2D, a < Lp} K2[c, i, a] * X2[w + a, i]

X2 is the (N, 2) re/im view of x, left-padded by L-1-gc samples and
viewed as (W, 2D); K2 is the (C2, 2D, Lp) s2d kernel of
`ops.fused.s2d_kernel`; the output is the un-derotated (C2, ceil(N/D))
channel pair in block row order [re.., im..].

  K1     `s2d_conv`: replaces `tetraear_tpu/ops/pallas/s2d_conv.py:_kernel`
         (entry point `pallas_s2d_conv_wk`); source `csrc/s2d_conv.cu`.
  K1-of  `s2d_conv_of`: the same `_kernel` as `pallas_s2d_conv_of_wk`
         launches it, `fold` output positions folded into kernel rows;
         K1's source with a fold, un-folded in its store.
  K3     `s2d_conv_db`: replaces `_kernel_db` (`_run_db`, variant "db"):
         K1's contraction with the next tile's input prefetched by
         cp.async; source `csrc/s2d_conv_db.cu`.  f32 only.
  K4     `s2d_conv_dt`: replaces `_kernel_direct` (entry point
         `pallas_s2d_conv_dt_wk`, variants "dt" / "dt_bf16"): the
         direct-tap form, per-tap weights read straight from memory into
         one running sum per output; source `csrc/s2d_conv_dt.cu`.

Each wrapper launches its kernel for CUDA tensors and runs the plain
version for CPU tensors; there is no other fallback.  `LAUNCHES` counts
each kernel's launches under its wrapper's name.
`pallas_s2d_conv` is the op-level drop-in of the reference's function of
that name.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
import torch.nn.functional as F

from tetraear_tpu_torch.ops.fir import conv1d_f32

# launches of K1, K1-of, K3 and K4, by wrapper name
LAUNCHES = {"s2d_conv": 0, "s2d_conv_of": 0, "s2d_conv_db": 0,
            "s2d_conv_dt": 0}

MAX_FOLD_CHANNELS = 128   # 2D * fold bound of the reference's K1-of
TILE_W = 256              # output positions of a K1 / K4 tile (s2d_tile.cuh)
MAX_SMEM_BYTES = 232_448  # dynamic shared memory of one block on Hopper


def _conv1d_f32(x2: torch.Tensor, k: torch.Tensor, stride: int,
                bf16: bool) -> torch.Tensor:
    """F.conv1d in f32 with TF32 off; bf16=True rounds both operands to
    bf16 first and still accumulates in f32."""
    if bf16:
        x2 = x2.to(torch.bfloat16).float()
        k = k.to(torch.bfloat16).float()
    return conv1d_f32(x2, k, stride)


def _x2_view(x: torch.Tensor, pad_l: int, total: int,
             decim: int) -> torch.Tensor:
    """x zero-padded to `total` samples (pad_l on the left) as the
    (1, 2D, total/D) conv input: the free (W, 2D) view, transposed."""
    n = x.shape[-1]
    xpad = F.pad(torch.view_as_real(x), (0, 0, pad_l, total - pad_l - n))
    return xpad.reshape(1, total // decim, 2 * decim).transpose(1, 2)


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
    out = _conv1d_f32(_x2_view(x, pad_l, total, decim), kernel_s2d, 1, bf16)
    return out[0, :, :m_out]


def s2d_conv_of_plain(x: torch.Tensor, kernel_of: torch.Tensor, gc: int,
                      L: int, decim: int, fold: int, *,
                      bf16: bool = False) -> torch.Tensor:
    """Output-folded plain version (port of
    `tetraear_tpu/ops/fused.py:_s2d_conv_folded`): a stride-`fold`
    F.conv1d of the (C2*fold, 2D, Lp+fold-1) kernel of
    `ops.fused.s2d_of_kernel` over the (W, 2D) view, then the un-fold of
    rows c*fold + r into positions w*fold + r.  -> (C2, ceil(N/D)) f32."""
    n = x.shape[-1]
    m_out = -(-n // decim)
    la = kernel_of.shape[-1]
    pad_l = L - 1 - gc
    wr = -(-m_out // fold)
    need = (wr - 1) * fold + la               # X2 positions the conv reads
    total = max(need * decim, -(-(pad_l + n) // decim) * decim)
    out = _conv1d_f32(_x2_view(x, pad_l, total, decim), kernel_of, fold,
                      bf16)[0, :, :wr]         # (C2*F, Wr)
    c2 = out.shape[0] // fold
    out = out.reshape(c2, fold, wr).transpose(1, 2).reshape(c2, wr * fold)
    return out[:, :m_out]


@functools.lru_cache(maxsize=None)
def _library(name: str) -> ctypes.CDLL:
    from tetraear_tpu_torch.ops.kernels import build
    lib, _report = build(name)
    fn = getattr(lib, f"tetra_{name}")
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
        ctypes.c_longlong,
        *((ctypes.c_int, ctypes.c_int) if name != "s2d_conv_db" else ()),
        ctypes.c_void_p]
    lib.tetra_cuda_error_string.restype = ctypes.c_char_p
    lib.tetra_cuda_error_string.argtypes = [ctypes.c_int]
    return lib


def _check(name: str, x: torch.Tensor, kernel: torch.Tensor, gc: int,
           L: int, decim: int, lp: int) -> None:
    """What the kernels take: both tensors on one card, a contiguous 1-D
    complex64 x, an f32 (rows, 2D, taps) kernel, 0 <= L-1-gc, L <= Lp*D."""
    if x.device.type != "cuda" or kernel.device != x.device:
        raise ValueError(f"{name}: x on {x.device} and kernel on "
                         f"{kernel.device}; the kernel takes both on one "
                         "card")
    if x.dtype != torch.complex64 or x.dim() != 1 or not x.is_contiguous():
        raise ValueError(f"{name}: x must be a contiguous 1-D complex64 "
                         f"tensor, got {x.dtype} {tuple(x.shape)}")
    if (kernel.dtype != torch.float32 or kernel.dim() != 3
            or kernel.shape[1] != 2 * decim):
        raise ValueError(f"{name}: kernel must be (rows, {2 * decim}, taps) "
                         f"float32, got {kernel.dtype} "
                         f"{tuple(kernel.shape)}")
    if L - 1 - gc < 0 or L > lp * decim:
        raise ValueError(f"{name}: need 0 <= L-1-gc and L <= Lp*D, got "
                         f"L={L} gc={gc} Lp={lp} D={decim}")


def _launch(wrapper: str, name: str, x: torch.Tensor, k_taps: torch.Tensor,
            c2: int, ich: int, lp: int, gc: int, L: int, decim: int,
            out_rows: int, *extra: int) -> torch.Tensor:
    """Runs tetra_<name> on x's stream and counts the launch under
    `wrapper`: k_taps is the tap-major (Lp, ich, C2) weight layout, so a
    block stages a row group's weights with coalesced loads.  ->
    (out_rows, ceil(N/D)) f32."""
    n = x.shape[0]
    m_out = -(-n // decim)
    out = torch.empty((out_rows, m_out), dtype=torch.float32,
                      device=x.device)
    if m_out == 0:
        return out
    lib = _library(name)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = getattr(lib, f"tetra_{name}")(
            torch.view_as_real(x).data_ptr(), 2 * n, k_taps.data_ptr(),
            out.data_ptr(), c2, ich, lp, 2 * (L - 1 - gc), m_out, *extra,
            stream)
    if err:
        raise RuntimeError(f"{wrapper}: launch failed: "
                           + lib.tetra_cuda_error_string(err).decode())
    LAUNCHES[wrapper] += 1
    return out


def s2d_conv(x: torch.Tensor, kernel_s2d: torch.Tensor, gc: int, L: int,
             decim: int, *, bf16: bool = False) -> torch.Tensor:
    """K1: x (N,) complex64 + s2d kernel (C2, 2D, Lp) f32 -> (C2,
    ceil(N/D)) f32.  bf16=True: bf16 operands, f32 accumulation."""
    if x.device.type == "cpu" and kernel_s2d.device.type == "cpu":
        return s2d_conv_plain(x, kernel_s2d, gc, L, decim, bf16=bf16)
    _check("s2d_conv", x, kernel_s2d, gc, L, decim, kernel_s2d.shape[-1])
    c2, ich, lp = kernel_s2d.shape
    return _launch("s2d_conv", "s2d_conv", x,
                   kernel_s2d.permute(2, 1, 0).contiguous(), c2, ich, lp, gc,
                   L, decim, c2, 1, int(bf16))


def check_fold(fold: int, decim: int) -> None:
    """K1-of takes 2D * fold <= 128 input channels, as the reference's
    of_group_weights does (tetraear_tpu/ops/pallas/s2d_conv.py:342)."""
    if fold < 1 or 2 * decim * fold > MAX_FOLD_CHANNELS:
        raise ValueError(
            f"K1-of: ich*fold = {2 * decim}*{fold} = {2 * decim * fold} "
            f"> {MAX_FOLD_CHANNELS} (or fold < 1); lower the fold for this "
            "decimation")


def s2d_conv_of(x: torch.Tensor, kernel_of: torch.Tensor, gc: int, L: int,
                decim: int, fold: int, *, bf16: bool = False) -> torch.Tensor:
    """K1-of: x (N,) complex64 + output-folded kernel (C2*fold, 2D,
    Lp+fold-1) f32 of `ops.fused.s2d_of_kernel` -> (C2, ceil(N/D)) f32,
    the same values as K1 up to the order of the sums.  The kernel runs
    K1 over the folded input (2D*fold channels, ceil((Lp+fold-1)/fold)
    taps) and un-folds in its store."""
    check_fold(fold, decim)
    if x.device.type == "cpu" and kernel_of.device.type == "cpu":
        return s2d_conv_of_plain(x, kernel_of, gc, L, decim, fold, bf16=bf16)
    c2f, ich, la = kernel_of.shape
    _check("s2d_conv_of", x, kernel_of, gc, L, decim, la - fold + 1)
    if c2f % fold:
        raise ValueError(f"s2d_conv_of: {c2f} kernel rows are not a "
                         f"multiple of fold {fold}")
    lp_of = -(-la // fold)
    # K3f[cf, f*2D + i, af] = K_of[cf, i, af*fold + f], tap-major
    k_taps = (F.pad(kernel_of, (0, lp_of * fold - la))
              .reshape(c2f, ich, lp_of, fold).permute(2, 3, 1, 0)
              .reshape(lp_of, fold * ich, c2f).contiguous())
    return _launch("s2d_conv_of", "s2d_conv", x, k_taps, c2f, fold * ich,
                   lp_of, gc, L, decim, c2f // fold, fold, int(bf16))


def s2d_conv_db(x: torch.Tensor, kernel_s2d: torch.Tensor, gc: int, L: int,
                decim: int) -> torch.Tensor:
    """K3: K1's contraction (f32) with the next tile's input window
    prefetched by cp.async; bit-identical to K1's f32 result.  Plain
    version: `s2d_conv_plain`."""
    if x.device.type == "cpu" and kernel_s2d.device.type == "cpu":
        return s2d_conv_plain(x, kernel_s2d, gc, L, decim)
    _check("s2d_conv_db", x, kernel_s2d, gc, L, decim, kernel_s2d.shape[-1])
    c2, ich, lp = kernel_s2d.shape
    return _launch("s2d_conv_db", "s2d_conv_db", x,
                   kernel_s2d.permute(2, 1, 0).contiguous(), c2, ich, lp, gc,
                   L, decim, c2)


def check_dt(ich: int, lp: int) -> None:
    """K4 keeps one tile's window, ich x (256 + Lp - 1) floats, in shared
    memory: refuse an input-channel count whose window does not fit (the
    reference fails on the same shapes with an opaque pad error)."""
    need = 4 * ich * ((TILE_W + lp - 1) | 1)
    if need > MAX_SMEM_BYTES:
        raise ValueError(
            f"K4: the window of {ich} input channels (2D) x {TILE_W + lp - 1}"
            f" positions is {need} bytes, over the {MAX_SMEM_BYTES} bytes of "
            "shared memory of one block; use K1 (variant 'dma') here")


def s2d_conv_dt(x: torch.Tensor, kernel_s2d: torch.Tensor, gc: int, L: int,
                decim: int, *, bf16: bool = False) -> torch.Tensor:
    """K4: K1's contraction in the direct-tap form, one running f32 sum
    per output over the per-tap weights K2[:, :, a].  x (N,) complex64 +
    s2d kernel (C2, 2D, Lp) f32 -> (C2, ceil(N/D)) f32; bf16=True: bf16
    operands, f32 accumulation.  Plain version: `s2d_conv_plain`."""
    c2, ich, lp = kernel_s2d.shape
    check_dt(ich, lp)
    if x.device.type == "cpu" and kernel_s2d.device.type == "cpu":
        return s2d_conv_plain(x, kernel_s2d, gc, L, decim, bf16=bf16)
    _check("s2d_conv_dt", x, kernel_s2d, gc, L, decim, lp)
    wkd = kernel_s2d.permute(2, 0, 1)          # (Lp, C2, 2D), the reference's
    if bf16:
        wkd = wkd.to(torch.bfloat16).float()
    c2p = -(-c2 // 32) * 32                    # whole row groups of 32
    k_taps = F.pad(wkd.transpose(1, 2), (0, c2p - c2)).contiguous()
    return _launch("s2d_conv_dt", "s2d_conv_dt", x, k_taps, c2, ich, lp, gc,
                   L, decim, c2, c2p, int(bf16))


def parse_fold(name: str, prefix: str) -> tuple:
    """'<prefix><N>' or '<prefix><N>_bf16' -> (N, bf16); anything else
    raises (tetraear_tpu/models/multicarrier.py:372-377)."""
    parts = name.removeprefix(prefix).split("_")
    if (not name.startswith(prefix) or not parts[0].isdigit()
            or parts[1:] not in ([], ["bf16"])):
        raise ValueError(f"unknown variant {name!r}; valid: {prefix}<N>, "
                         f"{prefix}<N>_bf16")
    return int(parts[0]), parts[1:] == ["bf16"]


def pallas_s2d_conv(x: torch.Tensor, kernel_s2d, gc: int, L: int,
                    decim: int, variant: str = "dma") -> torch.Tensor:
    """Drop-in for the reference's `pallas_s2d_conv`
    (tetraear_tpu/ops/pallas/s2d_conv.py:414): (N,) complex64 ->
    (C2, ceil(N/D)) f32.  Variants: 'dma' / 'bf16' -> K1, 'db' -> K3,
    'dt' / 'dt_bf16' -> K4, 'of<N>' / 'of<N>_bf16' -> K1-of with fold N."""
    if not isinstance(kernel_s2d, torch.Tensor):     # a writable copy
        kernel_s2d = torch.from_numpy(np.array(kernel_s2d, np.float32))
    k2 = kernel_s2d.to(device=x.device, dtype=torch.float32)
    if variant in ("dma", "bf16"):
        return s2d_conv(x, k2, gc, L, decim, bf16=variant == "bf16")
    if variant == "db":
        return s2d_conv_db(x, k2, gc, L, decim)
    if variant in ("dt", "dt_bf16"):
        return s2d_conv_dt(x, k2, gc, L, decim, bf16=variant == "dt_bf16")
    if variant.startswith("of"):
        fold, bf16 = parse_fold(variant, "of")
        from tetraear_tpu_torch.ops.fused import fold_s2d_kernel
        k_of = torch.as_tensor(fold_s2d_kernel(k2.cpu().numpy(), fold),
                               device=x.device)
        return s2d_conv_of(x, k_of, gc, L, decim, fold, bf16=bf16)
    raise ValueError(f"unknown variant {variant!r}; valid: dma, bf16, db, "
                     "dt, dt_bf16, of<N>, of<N>_bf16")
