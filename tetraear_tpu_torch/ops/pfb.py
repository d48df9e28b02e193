"""Polyphase DFT filterbank: all fs / 25 kHz channels at once (port of
`tetraear_tpu.ops.pfb`, whose module imports jax).

The designers are numpy copies; tests hold them `array_equal` to the
reference.  The gather forms compute, channel c in fftfreq order,

    y_c[m] = e^{-j 2pi c mD / C} C IDFT_r{ f[m, r] },
    f[m, r] = sum_p h[pC + r] x[mD - pC - r]:

per output, the length-P*C window ending at mD times the prototype,
folded over p, then a C-point IDFT and the oversampling rotation.  The
windows are gathered in chunks of 8192 outputs, as the reference's
`lax.map` does.  Both return N // D outputs (not ceil).  The dense-conv
form of the same filterbank is `ops.fused.pfb_kernel`.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def design_prototype(num_channels: int, taps_per_branch: int = 8,
                     cutoff_scale: float = 1.0) -> np.ndarray:
    """Lowpass prototype of length C*P with cutoff at half the channel
    spacing (scaled by cutoff_scale)."""
    from scipy.signal import firwin
    n = num_channels * taps_per_branch
    taps = firwin(n, cutoff_scale / num_channels)
    return taps.astype(np.float64)


def channel_offsets_hz(num_channels: int, sample_rate_hz: float) -> np.ndarray:
    """Center frequency of each filterbank channel (fftfreq order)."""
    return (np.fft.fftfreq(num_channels) * sample_rate_hz).astype(np.float32)


def _rotation_table(num_channels: int, decim: int) -> np.ndarray:
    """Oversampling rotation phase 2pi m c D / C over one period in m:
    (period, C) f64, period = C / gcd(C, D)."""
    period = num_channels // math.gcd(num_channels, decim)
    mm = np.arange(period)
    cc = np.arange(num_channels)
    return 2.0 * np.pi * np.outer(mm, cc) * decim / num_channels


def _windows(xp: torch.Tensor, start: int, stop: int, decim: int,
             pc: int) -> torch.Tensor:
    """Gather w[..., m - start, j] = x[mD - j] (xp = x left-padded by pc)
    for m in [start, stop): (..., stop - start, pc)."""
    m = torch.arange(start, stop, device=xp.device)
    idx = m[:, None] * decim - torch.arange(pc, device=xp.device) + pc
    return xp[..., idx]


def pfb_channelize(x: torch.Tensor, num_channels: int, decim: int,
                   taps=None, chunk: int = 8192) -> torch.Tensor:
    """x: (N,) complex64 -> (C, N // D) complex64.  Output m of channel c
    is the channel-c baseband at input position mD (causal window ending
    there; group delay = the prototype's)."""
    if taps is None:
        taps = design_prototype(num_channels)
    pc = len(taps)
    assert pc % num_channels == 0
    p = pc // num_channels
    m_total = x.shape[-1] // decim
    dev = x.device
    h = torch.as_tensor(taps, dtype=torch.float32, device=dev)
    th = _rotation_table(num_channels, decim)
    rot = torch.as_tensor(np.exp(-1j * th).astype(np.complex64), device=dev)
    xp = torch.nn.functional.pad(x, (pc, 0))
    out = []
    for start in range(0, m_total, chunk):
        stop = min(start + chunk, m_total)
        w = _windows(xp, start, stop, decim, pc) * h
        folded = w.reshape(stop - start, p, num_channels).sum(dim=1)
        y = torch.fft.ifft(folded, dim=-1) * num_channels
        m = torch.arange(start, stop, device=dev)
        out.append(y * rot[m % rot.shape[0]])
    if not out:
        return torch.zeros((num_channels, 0), dtype=torch.complex64,
                           device=dev)
    return torch.cat(out).to(torch.complex64).T


@functools.lru_cache(maxsize=None)
def _idft_tables(num_channels: int) -> tuple:
    """Real and imaginary parts of the C-point IDFT matrix W[r, c] =
    e^{+j 2pi rc / C}, f32."""
    r = np.arange(num_channels)
    th = 2.0 * np.pi * np.outer(r, r) / num_channels
    return (np.cos(th).astype(np.float32), np.sin(th).astype(np.float32))


def pfb_channelize_realpair(x_ri: torch.Tensor, num_channels: int,
                            decim: int, taps=None,
                            chunk: int = 8192) -> torch.Tensor:
    """Complex-free pfb_channelize: x_ri (2, N) f32 -> (2, C, N // D) f32,
    the IDFT as two real (C, C) matmuls and the rotation as real tables."""
    if taps is None:
        taps = design_prototype(num_channels)
    pc = len(taps)
    assert pc % num_channels == 0
    p = pc // num_channels
    m_total = x_ri.shape[-1] // decim
    dev = x_ri.device
    h = torch.as_tensor(taps, dtype=torch.float32, device=dev)
    cos_w, sin_w = (torch.as_tensor(t, device=dev)
                    for t in _idft_tables(num_channels))
    th = _rotation_table(num_channels, decim)
    rot_r = torch.as_tensor(np.cos(th).astype(np.float32), device=dev)
    rot_i = torch.as_tensor((-np.sin(th)).astype(np.float32), device=dev)
    xp = torch.nn.functional.pad(x_ri, (pc, 0))
    out = []
    for start in range(0, m_total, chunk):
        stop = min(start + chunk, m_total)
        w = _windows(xp, start, stop, decim, pc) * h      # (2, chunk, PC)
        folded = w.reshape(2, stop - start, p, num_channels).sum(dim=2)
        fr, fi = folded[0], folded[1]
        yr = fr @ cos_w - fi @ sin_w
        yi = fr @ sin_w + fi @ cos_w
        m = torch.arange(start, stop, device=dev) % rot_r.shape[0]
        rr, ri = rot_r[m], rot_i[m]
        out.append(torch.stack([yr * rr - yi * ri, yr * ri + yi * rr]))
    if not out:
        return torch.zeros((2, num_channels, 0), dtype=torch.float32,
                           device=dev)
    return torch.cat(out, dim=1).transpose(1, 2)
