"""Polyphase DFT-filterbank designers (numpy copies of
`tetraear_tpu.ops.pfb.design_prototype` and `channel_offsets_hz`, whose
module imports jax; tests hold them `array_equal` to the reference).

The filterbank itself runs as one dense conv (`ops.fused.pfb_kernel`
through the s2d conv).  The reference's gather forms, `pfb_channelize`
and `pfb_channelize_realpair`, feed its staged demod front
(`_demod_front`) and are ported with it (ROADMAP.md Queue 1, Slice 4).
"""

from __future__ import annotations

import functools

import numpy as np


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
