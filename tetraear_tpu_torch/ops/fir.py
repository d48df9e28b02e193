"""FIR designers (numpy + scipy, host side).

Copies of `tetraear_tpu.ops.fir.design_decimation_fir` and
`design_channel_fir`: that module imports jax at its top, so the port
keeps its own numpy copy.  tests/unit/test_torch_ops.py holds both
`array_equal` to the reference.
"""

from __future__ import annotations

import functools

import numpy as np


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
