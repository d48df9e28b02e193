"""Fused multicarrier front end: one composite space-to-depth ("s2d")
convolution does the per-carrier mixer, the decimating FIR and the
channel FIR together.

Host builders (numpy) are copies of `tetraear_tpu.ops.fused` (whose
module imports jax); tests hold them `array_equal` to the reference.
The derivation — the three LTI stages compose into one modulated
kernel, and the stride-D conv becomes a stride-1 conv over 2D input
channels — is in that module's docstrings.  The conv itself is
`ops.kernels.s2d_conv`: K1, K1-of, K3 and K4 and their plain F.conv1d
versions.  `pfb_kernel` states the 96-channel full-band filterbank as the
same kind of conv, `ddc_kernel` the mixer and decimating FIR alone.
`fused_channelize` / `fused_channelize_ri` are the legacy `fused=True`
form of the same operator: a stride-D F.conv1d of the (2C, 2, L) kernel,
then the residual rotation at the decimated rate.
`fused_channelize_s2d`, `fused_channelize_s2d_ri` and
`fused_channelize_s2d_of_ri` are the reference's op-level s2d
channelizers, on the plain convs (XLA convs in the reference, not Pallas
kernels); `MulticarrierFrontend.channelize` runs the two pair forms for
its `s2d` and `s2d_of` convs.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from tetraear_tpu_torch.ops import fir
from tetraear_tpu_torch.ops.kernels.s2d_conv import (s2d_conv_of_plain,
                                                     s2d_conv_plain)


@functools.lru_cache(maxsize=None)
def composite_taps(decim: int, taps_per_phase: int,
                   channel_taps: int, cutoff_norm: float) -> np.ndarray:
    """taps_d (*) upsample_D(taps_c): the single-rate composite filter."""
    taps_d = fir.design_decimation_fir(decim, taps_per_phase)
    taps_c = fir.design_channel_fir(channel_taps, cutoff_norm)
    up = np.zeros((len(taps_c) - 1) * decim + 1, np.float64)
    up[::decim] = taps_c
    return np.convolve(taps_d.astype(np.float64), up).astype(np.float32)


def modulated_kernel(taps: np.ndarray, offsets_hz: np.ndarray,
                     sample_rate_hz: float) -> tuple:
    """(2C, 2, L) real cross-correlation kernel of K_c[u] = taps[u]
    e^{+j2pi f_c u / fs}, output rows in block order [re_0..re_{C-1},
    im_0..im_{C-1}].  Returns (kernel, rotation_cycles = f_c / fs)."""
    h = np.asarray(taps, np.float64)
    L = len(h)
    offs = np.asarray(offsets_hz, np.float64)
    C = len(offs)
    u = np.arange(L, dtype=np.float64)
    ph = np.exp(2j * np.pi * offs[:, None] * u[None, :] / sample_rate_hz)
    Kc = (h[None, :] * ph)[:, ::-1]          # (C, L), reversed for corr
    kr = Kc.real.astype(np.float32)
    ki = Kc.imag.astype(np.float32)
    # out_re = x_re*Kr - x_im*Ki, out_im = x_re*Ki + x_im*Kr
    kernel = np.zeros((2 * C, 2, L), np.float32)
    kernel[:C, 0] = kr
    kernel[:C, 1] = -ki
    kernel[C:, 0] = ki
    kernel[C:, 1] = kr
    return kernel, offs / sample_rate_hz


def fused_kernel(offsets_hz: np.ndarray, sample_rate_hz: float,
                 decim: int, taps_per_phase: int, channel_taps: int,
                 cutoff_norm: float) -> tuple:
    """DDC-bank composite kernel: (kernel, group_delay, rotation_cycles)."""
    h = composite_taps(decim, taps_per_phase, channel_taps, cutoff_norm)
    g1 = (taps_per_phase * decim + 1 - 1) // 2
    g2 = (channel_taps | 1) // 2            # design pads to odd
    gc = g2 * decim + g1
    kernel, rot = modulated_kernel(h, offsets_hz, sample_rate_hz)
    return kernel, gc, rot


def ddc_kernel(offsets_hz: np.ndarray, sample_rate_hz: float,
               decim: int, taps_per_phase: int) -> tuple:
    """Mixer + decimation FIR only (no channel FIR) as one dense conv
    kernel: the etsi multicarrier downlink's channelizer front, the values
    of ops/channelizer.channelize (on the card K5 computes that directly,
    models/downlink.MulticarrierDownlinkReceiver).  Returns (kernel, gc,
    rotation_cycles)."""
    taps_d = fir.design_decimation_fir(decim, taps_per_phase)
    gc = (taps_per_phase * decim + 1 - 1) // 2
    kernel, rot = modulated_kernel(taps_d, offsets_hz, sample_rate_hz)
    return kernel, gc, rot


def symbol_rotation(rot_cycles: np.ndarray, decim: int, sps: int) -> tuple:
    """Per-carrier (cos, sin) of Delta_c = 2pi f_c D sps / fs: the residual
    rotation enters the differential product of symbols sps channel
    samples apart as this constant, so the demod tail applies it to z
    instead of derotating every channel sample."""
    d = np.asarray(rot_cycles, np.float64) * decim * sps
    d = 2.0 * np.pi * (d - np.round(d))
    return np.cos(d).astype(np.float32), np.sin(d).astype(np.float32)


def _rotation_period(rot_cycles: np.ndarray, max_q: int = 4608) -> int:
    """Smallest Q with every f_c Q / fs an integer (0 if none <= max_q):
    96 on the 25 kHz grid at 2.4 MS/s, where the residual rotation is an
    exact function of (start + Gc + mD) mod Q."""
    for q in range(1, max_q + 1):
        if np.allclose(rot_cycles * q, np.round(rot_cycles * q),
                       atol=1e-12):
            return q
    return 0


def pair_rows(out: torch.Tensor) -> tuple:
    """A conv's (2C, M) output, rows [re.., im..] -> (yr, yi)."""
    c = out.shape[0] // 2
    return out[:c], out[c:]


def _strided_conv(x: torch.Tensor, kernel, gc: int, decim: int) -> tuple:
    """Un-derotated (yr, yi) of the stride-D conv of the (2C, 2, L)
    kernel, m = ceil(N/D) outputs: output m reads x[mD + gc - u]."""
    n = x.shape[-1]
    m_out = -(-n // decim)
    k = _weights(kernel, x.device)
    pad_l = k.shape[-1] - 1 - gc
    pad_r = max(0, (m_out - 1) * decim + gc + 1 - n)
    xri = F.pad(torch.stack([x.real, x.imag])[None], (pad_l, pad_r))
    return pair_rows(fir.conv1d_f32(xri, k, decim)[0])


def _rotation(rot_cycles, gc: int, decim: int, m_out: int, start_index,
              device) -> tuple:
    """(cos, sin) of the residual phase 2pi f_c (start + gc + mD) / fs,
    (C, M) f32: from a host table on a grid with a rotation period, else
    in f32 with the cycle count reduced to [-1/2, 1/2], as the
    reference."""
    rot_cycles = np.asarray(rot_cycles, np.float64)
    q = _rotation_period(rot_cycles)
    if q:
        th = 2.0 * np.pi * rot_cycles[:, None] * np.arange(q)[None, :]
        cos_t = torch.as_tensor(np.cos(th).astype(np.float32), device=device)
        sin_t = torch.as_tensor(np.sin(th).astype(np.float32), device=device)
        p = q // math.gcd(decim % q or q, q)
        m0 = torch.arange(p, dtype=torch.int32, device=device)
        idx0 = ((int(start_index) + gc + m0 * decim) % q).long()
        reps = -(-m_out // p)
        return (cos_t[:, idx0].tile(1, reps)[:, :m_out],
                sin_t[:, idx0].tile(1, reps)[:, :m_out])
    m = torch.arange(m_out, dtype=torch.float32, device=device)
    base = float(np.float32(start_index) + np.float32(gc))   # an f32 sum
    arg = (torch.as_tensor(rot_cycles, dtype=torch.float32,
                           device=device)[:, None]
           * (torch.full((), base, dtype=torch.float32, device=device)
              + m[None, :] * decim))
    arg = 2.0 * math.pi * (arg - torch.round(arg))
    return torch.cos(arg), torch.sin(arg)


def fused_channelize_ri(x: torch.Tensor, kernel, gc: int, rot_cycles,
                        decim: int, start_index: int = 0,
                        rotate: bool = True) -> tuple:
    """x: (N,) complex64 -> (yr, yi) f32 (C, ceil(N/D)), the values of
    `fused_channelize` as a real pair.  rotate=False returns the conv
    alone; the demod tail then applies symbol_rotation to z."""
    yr, yi = _strided_conv(x, kernel, gc, decim)
    if not rotate:
        return yr, yi
    cr, si = _rotation(rot_cycles, gc, decim, yr.shape[-1], start_index,
                       x.device)
    # (yr + j yi) e^{-j theta} = (yr c + yi s) + j (yi c - yr s)
    return yr * cr + yi * si, yi * cr - yr * si


def fused_channelize(x: torch.Tensor, kernel, gc: int, rot_cycles,
                     decim: int, start_index: int = 0,
                     rotate: bool = True) -> torch.Tensor:
    """x: (N,) complex64 -> (C, ceil(N/D)) complex64 carriers, the values
    of channelizer.channelize + fir.fir_filter_same (the same operator as
    one dense conv).  rotate=False returns the un-derotated channels."""
    yr, yi = _strided_conv(x, kernel, gc, decim)
    y = torch.complex(yr, yi)
    if not rotate:
        return y
    cr, si = _rotation(rot_cycles, gc, decim, y.shape[-1], start_index,
                       x.device)
    return y * torch.complex(cr, -si)


def _weights(kernel, device) -> torch.Tensor:
    """A conv kernel (numpy or tensor) as f32 on `device`."""
    if not isinstance(kernel, torch.Tensor):        # a writable copy
        kernel = torch.from_numpy(np.array(kernel, np.float32))
    return kernel.to(device=device, dtype=torch.float32)


def fused_channelize_s2d(x: torch.Tensor, kernel_s2d, gc: int, L: int,
                         rot_cycles, decim: int, start_index: int = 0,
                         rotate: bool = True) -> torch.Tensor:
    """fused_channelize by the space-to-depth stride-1 conv of the
    (2C, 2D, Lp) kernel (`s2d_kernel`; L the composite's length before
    padding): x (N,) complex64 -> (C, ceil(N/D)) complex64 carriers, the
    same operator in another summation order.  rotate=False returns the
    un-derotated channels (pair with symbol_rotation)."""
    yr, yi = fused_channelize_s2d_ri(x, kernel_s2d, gc, L, decim)
    y = torch.complex(yr, yi)
    if not rotate:
        return y
    cr, si = _rotation(rot_cycles, gc, decim, y.shape[-1], start_index,
                       x.device)
    return y * torch.complex(cr, -si)


def fused_channelize_s2d_ri(x: torch.Tensor, kernel_s2d, gc: int, L: int,
                            decim: int) -> tuple:
    """(yr, yi) f32 (C, ceil(N/D)): the un-derotated pair of the s2d conv,
    the real-pair tail's feed."""
    return pair_rows(s2d_conv_plain(x, _weights(kernel_s2d, x.device), gc,
                                    L, decim))


def fused_channelize_s2d_of_ri(x: torch.Tensor, kernel_of, gc: int, L: int,
                               decim: int, fold: int) -> tuple:
    """(yr, yi): fused_channelize_s2d_ri's values by the output-folded s2d
    conv of the (2C fold, 2D, Lp + fold - 1) kernel (`s2d_of_kernel`)."""
    return pair_rows(s2d_conv_of_plain(x, _weights(kernel_of, x.device), gc,
                                       L, decim, fold))


def s2d_kernel(kernel: np.ndarray, decim: int) -> np.ndarray:
    """(2C, 2, L) composite kernel -> (2C, 2D, Lp) s2d kernel, Lp =
    ceil(L/D), input channel index r*2 + j (r: phase in the decimation
    block, j: re/im)."""
    k = np.asarray(kernel)
    c2, _, L = k.shape
    lp = -(-L // decim)
    kp = np.zeros((c2, 2, lp * decim), np.float32)
    kp[:, :, :L] = k
    k4 = kp.reshape(c2, 2, lp, decim)          # [c, j, a, r]
    return np.ascontiguousarray(
        k4.transpose(0, 3, 1, 2)).reshape(c2, 2 * decim, lp)



def pfb_kernel(num_channels: int, sample_rate_hz: float,
               taps: np.ndarray | None = None,
               taps_per_branch: int = 8) -> tuple:
    """The full-band polyphase filterbank as one dense conv: K_c[k] = h[k]
    e^{+j2pi c k / C} over the C fftfreq channels, h the prototype
    lowpass.  Returns (kernel, gc = 0, rotation_cycles)."""
    from tetraear_tpu_torch.ops import pfb
    if taps is None:
        taps = pfb.design_prototype(num_channels, taps_per_branch)
    offs = pfb.channel_offsets_hz(num_channels, sample_rate_hz)
    kernel, rot = modulated_kernel(np.asarray(taps), offs, sample_rate_hz)
    return kernel, 0, rot


def fold_s2d_kernel(k2: np.ndarray, fold: int) -> np.ndarray:
    """(C2, 2D, Lp) s2d kernel -> (C2*fold, 2D, Lp+fold-1) output-folded
    kernel: row c*fold + r holds K2[c] delayed by r taps, so a stride-fold
    conv gives out[c, w*fold + r] in row c*fold + r."""
    k2 = np.asarray(k2, np.float32)
    c2, ich, lp = k2.shape
    k3 = np.zeros((c2, fold, ich, lp + fold - 1), np.float32)
    for r in range(fold):
        k3[:, r, :, r:r + lp] = k2
    return k3.reshape(c2 * fold, ich, lp + fold - 1)


def s2d_of_kernel(kernel: np.ndarray, decim: int, fold: int) -> np.ndarray:
    """(2C, 2, L) composite kernel -> (2C*fold, 2D, Lp+fold-1) output-
    folded s2d kernel (the reference's s2d_of_kernel)."""
    return fold_s2d_kernel(s2d_kernel(kernel, decim), fold)
