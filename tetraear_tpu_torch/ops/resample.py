"""Polyphase rational resampling by L/M as strided convolutions (port of
`tetraear_tpu.ops.resample`, whose module imports jax).

The `etsi` profile's 240 kHz -> 72 kHz step (x3/10) onto exactly 4
samples per 18 kHz symbol.  upfirdn semantics with zero-phase alignment:

    y[m] = sum_k h[k] xu[m M + delay - k],   delay = (len(h) - 1) // 2,
    xu[i] = x[i / L] where L divides i, else 0

split per output phase q = m mod L into L plain strided correlations
with the kernels g_q[j] = h[k0(q) + L j]: no zero-stuffed buffer.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from tetraear_tpu_torch.ops.fir import conv1d_f32, design_rrc


@functools.lru_cache(maxsize=None)
def _phase_plan(num_taps: int, L: int, M: int):
    """Per-phase (tap indices, input offset of output 0) and the delay."""
    delay = (num_taps - 1) // 2
    plans = []
    for q in range(L):
        k0 = (q * M + delay) % L
        g = np.arange(k0, num_taps, L)
        b_q = (q * M + delay - k0) // L
        plans.append((g, b_q))
    return plans, delay


def _strided_corr(x: torch.Tensor, kern: torch.Tensor, stride: int,
                  num_out: int) -> torch.Tensor:
    """Real rows (..., n) correlated with kern at stride: (..., num_out)."""
    need = (num_out - 1) * stride + kern.shape[0]
    if x.shape[-1] < need:
        x = F.pad(x, (0, need - x.shape[-1]))
    x = x[..., :need]
    out = conv1d_f32(x.reshape(-1, 1, need), kern[None, None, :], stride)
    return out[:, 0, :].reshape(x.shape[:-1] + (num_out,))


@functools.lru_cache(maxsize=None)
def _phase_kernels(taps: bytes, L: int, M: int, device: torch.device
                   ) -> tuple:
    """Per phase: (reversed kernel g_q as f32 on `device`, its length,
    b_q), made once per (taps, L, M, device)."""
    h = np.frombuffer(taps, np.float64)
    plans, _ = _phase_plan(len(h), L, M)
    return tuple((torch.as_tensor(h[idx][::-1].copy(), dtype=torch.float32,
                                  device=device), len(idx), b_q)
                 for idx, b_q in plans)


def rational_resample(x: torch.Tensor, L: int, M: int,
                      taps) -> torch.Tensor:
    """x: (..., N) complex or real -> (..., L floor(N L / M / L))."""
    assert np.gcd(L, M) == 1
    taps = np.asarray(taps, np.float64)
    squeeze = x.dim() == 1
    if squeeze:
        x = x[None, :]
    n = x.shape[-1]
    blocks = (n * L) // M // L                    # outputs per phase
    outs = []
    for kern, j, b_q in _phase_kernels(taps.tobytes(), L, M, x.device):
        # y_q[i] = sum_j g[j] x[i M + b_q - j]: the correlation with g
        # reversed, read from i M + b_q - (j - 1)
        start = b_q - (j - 1)
        pad_l = max(0, -start)
        pad_r = max(0, (blocks - 1) * M + b_q + 1 + pad_l - n + 8)
        seg = F.pad(x, (pad_l, pad_r))[..., start + pad_l:]
        if x.is_complex():
            outs.append(torch.complex(
                _strided_corr(seg.real, kern, M, blocks),
                _strided_corr(seg.imag, kern, M, blocks)))
        else:
            outs.append(_strided_corr(seg.to(torch.float32), kern, M,
                                      blocks))
    y = torch.stack(outs, dim=-1).reshape(x.shape[:-1] + (blocks * L,))
    return y[0] if squeeze else y


@functools.lru_cache(maxsize=None)
def design_rrc_resampler(L: int, M: int, sps_out: int, alpha: float = 0.35,
                         span_symbols: int = 10) -> np.ndarray:
    """Anti-alias + RRC matched filter at the virtual rate L fs_in: one
    symbol spans sps_out M virtual samples; gain L (upfirdn's)."""
    taps = design_rrc(sps_out * M, alpha, span_symbols).astype(np.float64)
    return taps * L
