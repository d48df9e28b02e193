"""Spectrum estimation, signal detection and the grid-comb AFC (port of
`tetraear_tpu.ops.spectrum`).

2048-point Hann FFT in dBFS (`torch.fft` on the tensor's device, f32),
in-band / out-of-band power statistics with the reference's SNR gate, the
sub-bin parabolic peak, and the shared tuner offset of a 25 kHz channel
grid, batched over frames.  The host parts (`fft_freqs`,
`parabolic_peak`, the fold of `estimate_grid_offset_hz`) are numpy copies
of the reference's.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from tetraear_tpu_torch import constants as C


def spectrum_dbfs(x: torch.Tensor, n_fft: int = C.SPECTRUM_FFT_SIZE
                  ) -> torch.Tensor:
    """Hann-windowed power spectrum in dBFS, fftshifted.

    x: (..., N) complex with N >= n_fft; uses the first n_fft samples per
    row.  Returns (..., n_fft) float32.
    """
    seg = x[..., :n_fft]
    win = torch.as_tensor(np.hanning(n_fft), dtype=torch.float32,
                          device=x.device)
    f = torch.fft.fftshift(torch.fft.fft(seg * win), dim=-1)
    return (20.0 * torch.log10(f.abs() / n_fft + 1e-20)).to(torch.float32)


def spectrum_frames_dbfs(x: torch.Tensor, n_fft: int = C.SPECTRUM_FFT_SIZE,
                         hop: int | None = None) -> torch.Tensor:
    """Waterfall: x (N,) complex -> (num_frames, n_fft) float32, one
    spectrum per frame of n_fft samples every `hop` (default n_fft)."""
    if hop is None:
        hop = n_fft
    n = x.shape[-1]
    num = max(0, (n - n_fft) // hop + 1)
    if num == 0:
        return torch.zeros((0, n_fft), dtype=torch.float32, device=x.device)
    frames = x[: (num - 1) * hop + n_fft].unfold(-1, n_fft, hop)
    return spectrum_dbfs(frames, n_fft)


def fft_freqs(n_fft: int, sample_rate_hz: float) -> np.ndarray:
    """fftshifted baseband bin frequencies."""
    return np.fft.fftshift(np.fft.fftfreq(n_fft, 1.0 / sample_rate_hz))


class DetectionResult(NamedTuple):
    signal_present: torch.Tensor   # bool
    signal_power: torch.Tensor     # mean in-band dBFS
    peak_power: torch.Tensor       # max in-band dBFS
    noise_floor: torch.Tensor      # mean out-of-band dBFS
    snr: torch.Tensor
    afc_offset_hz: torch.Tensor    # peak bin baseband frequency


def detect_signal(power_db: torch.Tensor, sample_rate_hz: float,
                  n_fft: int = C.SPECTRUM_FFT_SIZE,
                  bandwidth_hz: float = C.CHANNEL_BANDWIDTH_HZ
                  ) -> DetectionResult:
    """The reference's chunk-level signal gate.

    power_db: (..., n_fft) fftshifted dBFS spectrum.
    Gate: SNR > 15 dB AND peak > -70 dBFS AND (peak - avg) > 3 dB, with the
    in-band window = bandwidth_hz around DC and the noise floor averaged
    from bins at least 10 away from the band edges.
    """
    center = n_fft // 2
    freq_res = sample_rate_hz / n_fft
    bw_bins = int(bandwidth_hz / freq_res)
    start = max(0, center - bw_bins // 2)
    end = min(n_fft, center + bw_bins // 2)

    band = power_db[..., start:end]
    signal_power = band.mean(dim=-1)
    peak_power = band.amax(dim=-1)
    peak_idx = start + torch.argmax(band, dim=-1)
    freqs = torch.as_tensor(fft_freqs(n_fft, sample_rate_hz),
                            dtype=torch.float32, device=power_db.device)
    afc = freqs[peak_idx]

    noise_parts = []
    if start - 10 > 0:
        noise_parts.append(power_db[..., : start - 10])
    if end + 10 < n_fft:
        noise_parts.append(power_db[..., end + 10:])
    if noise_parts:
        noise = torch.cat(noise_parts, dim=-1).mean(dim=-1)
    else:
        noise = torch.full(power_db.shape[:-1], -100.0,
                           dtype=power_db.dtype, device=power_db.device)

    snr = signal_power - noise
    peak_above_avg = peak_power - signal_power
    present = ((snr > C.DETECT_SNR_DB)
               & (peak_power > C.DETECT_PEAK_DBFS)
               & (peak_above_avg > C.DETECT_PEAK_ABOVE_AVG_DB))
    return DetectionResult(present, signal_power, peak_power, noise, snr, afc)


def parabolic_peak(power_db: np.ndarray, freqs: np.ndarray,
                   lo_hz: float, hi_hz: float) -> float:
    """Sub-bin quadratic peak interpolation (host): the max bin in
    [lo, hi] refined with a three-point parabola, the offset clamped to
    +/-1 bin."""
    mask = (freqs >= lo_hz) & (freqs <= hi_hz)
    if not np.any(mask):
        return float((lo_hz + hi_hz) / 2)
    idxs = np.where(mask)[0]
    i = int(idxs[np.argmax(power_db[idxs])])
    if 0 < i < len(power_db) - 1:
        y1, y2, y3 = power_db[i - 1], power_db[i], power_db[i + 1]
        denom = y1 - 2 * y2 + y3
        if denom != 0:
            delta = float(np.clip(0.5 * (y1 - y3) / denom, -1.0, 1.0))
            x1, x2, x3 = freqs[i - 1], freqs[i], freqs[i + 1]
            step = float((x3 - x1) / 2.0) if x3 != x1 else float(x3 - x2)
            return float(x2 + delta * step)
    return float(freqs[i])


def estimate_grid_offset_hz(x, sample_rate_hz: float,
                            spacing_hz: float = 25e3,
                            n_fft: int = 4096,
                            gate_db: float = 10.0,
                            channel_half_hz: float = 9e3, *,
                            device) -> float:
    """Common frequency offset of the TETRA channel grid (hardware ppm).

    Every active carrier sits on the spacing_hz grid shifted by one
    shared tuner error, so folding the average spectrum (frames on
    `device`) modulo the spacing and taking the power-weighted circular
    mean of the occupied bins recovers that offset.  Returns the offset
    in Hz, in [-spacing/2, spacing/2); subtract it before channelizing on
    grid offsets.
    """
    if len(x) < n_fft:
        return 0.0
    frames = spectrum_frames_dbfs(
        torch.as_tensor(np.asarray(x, np.complex64), device=device),
        n_fft).cpu().numpy()
    if frames.size == 0:
        return 0.0
    avg_db = frames.mean(axis=0)                      # (n_fft,) dBFS
    freqs = fft_freqs(n_fft, sample_rate_hz)
    # gate: occupied bins stand gate_db above the median floor
    floor = np.median(avg_db)
    sel = avg_db > floor + gate_db
    if not np.any(sel):
        return 0.0
    w = 10.0 ** ((avg_db[sel] - avg_db[sel].max()) / 10.0)  # linear, peak=1
    theta = 2.0 * np.pi * (freqs[sel] % spacing_hz) / spacing_hz
    # two passes: anchor on the strongest bin's fold phase, then average
    # only bins within half a channel of it, so that modulation sidelobes
    # passing the gate at unrelated fold phases do not bias the mean
    phi0 = theta[np.argmax(w)]
    half = 2.0 * np.pi * (channel_half_hz / spacing_hz)
    d = np.angle(np.exp(1j * (theta - phi0)))         # circular distance
    keep = np.abs(d) <= half
    z = np.sum(w[keep] * np.exp(1j * theta[keep]))
    if abs(z) < 1e-12:
        return 0.0
    frac = np.angle(z) / (2.0 * np.pi)                # (-0.5, 0.5]
    off = frac * spacing_hz
    if off >= spacing_hz / 2:
        off -= spacing_hz
    return float(off)
