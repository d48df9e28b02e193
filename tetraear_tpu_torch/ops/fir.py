"""FIR design (numpy + scipy, host side) and application (PyTorch).

The designers are copies of `tetraear_tpu.ops.fir.design_decimation_fir`,
`design_channel_fir` and `design_rrc`: that module imports jax at its
top, so the port keeps its own numpy copy.  tests/unit/test_torch_ops.py
and test_torch_receiver.py hold them `array_equal` to the reference.
`fir_decimate` and `fir_filter_same` are the reference's strided real
convolutions as F.conv1d, in f32; `fir_decimate_halo` is their
overlap-save form for a time-sharded block.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=None)
def design_decimation_fir(decim: int, taps_per_phase: int = 16) -> np.ndarray:
    """Linear-phase FIR matching |cheby1(8, 0.05, 0.8/decim)|^2 — the
    squared magnitude that scipy.signal.decimate's filtfilt applies."""
    from scipy import signal as sps

    numtaps = taps_per_phase * decim + 1   # odd -> integer group delay
    b, a = sps.cheby1(8, 0.05, 0.8 / decim)
    freqs = np.linspace(0.0, 1.0, 512)
    _, h = sps.freqz(b, a, worN=freqs * np.pi)
    gain = np.abs(h) ** 2
    gain[-1] = 0.0
    taps = sps.firwin2(numtaps, freqs, gain)
    return taps.astype(np.float32)


@functools.lru_cache(maxsize=None)
def design_channel_fir(num_taps: int, cutoff_norm: float) -> np.ndarray:
    """Linear-phase FIR matching |butter(4, cutoff)|^2; ``cutoff_norm`` is
    a fraction of Nyquist, clipped to [0.01, 0.99]."""
    from scipy import signal as sps

    if num_taps % 2 == 0:
        num_taps += 1
    cutoff_norm = min(0.99, max(0.01, cutoff_norm))
    b, a = sps.butter(4, cutoff_norm, btype="low")
    freqs = np.linspace(0.0, 1.0, 512)
    _, h = sps.freqz(b, a, worN=freqs * np.pi)
    gain = np.abs(h) ** 2
    gain[-1] = 0.0
    taps = sps.firwin2(num_taps, freqs, gain)
    return taps.astype(np.float32)


@functools.lru_cache(maxsize=None)
def design_rrc(sps_: int, alpha: float, span_symbols: int) -> np.ndarray:
    """Root-raised-cosine matched filter of the `etsi` profile, unit
    energy (alpha = 0.35, ETSI EN 300 392-2's modulation filter)."""
    n = sps_ * span_symbols + 1
    t = (np.arange(n) - (n - 1) / 2) / sps_
    taps = np.zeros_like(t)
    for i, ti in enumerate(t):
        if abs(ti) < 1e-9:
            taps[i] = 1.0 - alpha + 4 * alpha / np.pi
        elif abs(abs(4 * alpha * ti) - 1.0) < 1e-9:
            taps[i] = (alpha / np.sqrt(2)) * (
                (1 + 2 / np.pi) * np.sin(np.pi / (4 * alpha))
                + (1 - 2 / np.pi) * np.cos(np.pi / (4 * alpha)))
        else:
            num = (np.sin(np.pi * ti * (1 - alpha))
                   + 4 * alpha * ti * np.cos(np.pi * ti * (1 + alpha)))
            den = np.pi * ti * (1 - (4 * alpha * ti) ** 2)
            taps[i] = num / den
    taps /= np.sqrt(np.sum(taps ** 2))
    return taps.astype(np.float32)


def conv1d_f32(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
               padding: int = 0) -> torch.Tensor:
    """F.conv1d in full f32: cuDNN runs f32 convolutions in TF32 unless
    told not to, which keeps only about three decimal digits."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        return F.conv1d(x, w, stride=stride, padding=padding)
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def _conv1d_real(x: torch.Tensor, taps, stride: int,
                 pad: tuple) -> torch.Tensor:
    """Strided 1-D cross-correlation of real batched signals, zero-padded
    by pad = (left, right): x (B, N) f32, taps (L,) -> (B, M)."""
    taps = torch.as_tensor(taps, dtype=torch.float32, device=x.device)
    lo, hi = pad
    if lo != hi:
        x, lo = F.pad(x, (lo, hi)), 0
    return conv1d_f32(x[:, None, :], taps[None, None, :], stride, lo)[:, 0]


def fir_decimate(x: torch.Tensor, taps, decim: int) -> torch.Tensor:
    """Zero-phase FIR filter + decimate on scipy's output grid: for odd
    taps of length L = 2G+1, y[m] = sum_k taps[k] x[m*decim + G - k] with
    zero padding.  x: complex64 (B, N) or (N,) -> complex64 (B,
    ceil(N/decim)).  Real and imaginary rows go through one conv."""
    squeeze = x.dim() == 1
    if squeeze:
        x = x[None, :]
    g = (len(taps) - 1) // 2
    b = x.shape[0]
    ri = _conv1d_real(torch.cat([x.real, x.imag]), taps, decim, (g, g))
    y = torch.complex(ri[:b], ri[b:])
    return y[0] if squeeze else y


def fir_filter_same(x: torch.Tensor, taps) -> torch.Tensor:
    """Zero-phase 'same' FIR filter (stride 1)."""
    return fir_decimate(x, taps, 1)


def fir_decimate_halo(x: torch.Tensor, taps, decim: int,
                      left_halo: torch.Tensor, right_halo: torch.Tensor
                      ) -> torch.Tensor:
    """Overlap-save fir_decimate: the neighbours' G = (L-1)//2 samples on
    each side take the place of the zero padding, so a sharded block's
    outputs equal the unsharded ones.  The block's length is a multiple
    of decim; the halos have G samples each."""
    xp = torch.cat([left_halo, x, right_halo], dim=-1)
    squeeze = xp.dim() == 1
    if squeeze:
        xp = xp[None, :]
    b = xp.shape[0]
    ri = _conv1d_real(torch.cat([xp.real, xp.imag]), taps, decim, (0, 0))
    y = torch.complex(ri[:b], ri[b:])
    return y[0] if squeeze else y
