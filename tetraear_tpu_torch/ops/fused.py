"""Fused multicarrier front end: one composite space-to-depth ("s2d")
convolution does the per-carrier mixer, the decimating FIR and the
channel FIR together.

Host builders (numpy) are copies of `tetraear_tpu.ops.fused` (whose
module imports jax); tests hold them `array_equal` to the reference.
The derivation — the three LTI stages compose into one modulated
kernel, and the stride-D conv becomes a stride-1 conv over 2D input
channels — is in that module's docstrings.  The conv itself is
`ops.kernels.s2d_conv`: K1, K1-of and K3 and their plain F.conv1d
versions.  `pfb_kernel` states the 96-channel full-band filterbank as the
same kind of conv.
"""

from __future__ import annotations

import functools

import numpy as np

from tetraear_tpu_torch.ops import fir


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


def symbol_rotation(rot_cycles: np.ndarray, decim: int, sps: int) -> tuple:
    """Per-carrier (cos, sin) of Delta_c = 2pi f_c D sps / fs: the residual
    rotation enters the differential product of symbols sps channel
    samples apart as this constant, so the demod tail applies it to z
    instead of derotating every channel sample."""
    d = np.asarray(rot_cycles, np.float64) * decim * sps
    d = 2.0 * np.pi * (d - np.round(d))
    return np.cos(d).astype(np.float32), np.sin(d).astype(np.float32)


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
