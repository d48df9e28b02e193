"""The plain reference of the wideband decode, in float64 PyTorch, and
the precision control.  It imports nothing of the program and takes
nothing the program made: it designs its own filters (frozen copies of
the designers, below), mixes and filters the same IQ chunk by one FFT
convolution per carrier, and demodulates, correlates and picks
candidates with the semantics of the program's plain versions.

What the reference computes for a chunk x of N samples, for the carrier
or channel c at offset f_c (fs the sample rate, D the decimation, h the
lowpass of L taps, gc its group delay):

    y_c[m] = e^{-j 2pi f_c (mD + gc) / fs} sum_u h[u] e^{+j 2pi f_c u / fs}
             x[mD + gc - u],        m in [0, ceil(N / D)),

the channel at 1 / D of the rate (x = 0 outside [0, N)); then the
symbols at the phase phi of the 13 with the most power,
s[k] = y[13 k + phi], z[k] = s[k + 1] conj(s[k]), and the dibit of the
sector z falls in (`SECTORS`).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark import golden as G

SPS = 13   # symbols are picked every 13 channel samples (240 kHz / 18 kHz)

# quantizer sectors of z by angle: (centre, half width); the program's
# bins 0..3 (bin 0 wins ties at its edge, z = 0 falls into bin 3)
SECTORS = ((0.0, 3 * math.pi / 8), (math.pi / 2, math.pi / 8),
           (-math.pi / 2, math.pi / 8), (math.pi, 3 * math.pi / 8))


# -------------------------------------------------------------- designs
# frozen copies of tetraear_tpu_torch/ops/fir.py design_decimation_fir
# :22 and design_channel_fir :38, ops/fused.py composite_taps :39 and
# fused_kernel :79 (group delay), ops/pfb.py design_prototype :27 and
# channel_offsets_hz :37, ops/channelizer.py carrier_grid :20; kept in
# float64 here (the program rounds its taps to float32)

def decimation_fir(decim: int, taps_per_phase: int) -> np.ndarray:
    """Linear-phase FIR matching |cheby1(8, 0.05, 0.8 / decim)|^2."""
    from scipy import signal as sps
    b, a = sps.cheby1(8, 0.05, 0.8 / decim)
    freqs = np.linspace(0.0, 1.0, 512)
    _, h = sps.freqz(b, a, worN=freqs * np.pi)
    gain = np.abs(h) ** 2
    gain[-1] = 0.0
    return sps.firwin2(taps_per_phase * decim + 1, freqs, gain)


def channel_fir(num_taps: int, cutoff_norm: float) -> np.ndarray:
    """Linear-phase FIR matching |butter(4, cutoff)|^2."""
    from scipy import signal as sps
    num_taps |= 1
    cutoff_norm = min(0.99, max(0.01, cutoff_norm))
    b, a = sps.butter(4, cutoff_norm, btype="low")
    freqs = np.linspace(0.0, 1.0, 512)
    _, h = sps.freqz(b, a, worN=freqs * np.pi)
    gain = np.abs(h) ** 2
    gain[-1] = 0.0
    return sps.firwin2(num_taps, freqs, gain)


def carrier_grid(num_carriers: int, spacing_hz: float = 25e3) -> np.ndarray:
    """Symmetric grid around the centre: an even count lands on odd
    multiples of spacing / 2."""
    return (np.arange(num_carriers) - (num_carriers - 1) / 2.0) * spacing_hz


def channel_offsets(num_channels: int, sample_rate_hz: float) -> np.ndarray:
    """Every channel of the full band, in fftfreq order."""
    return np.fft.fftfreq(num_channels) * sample_rate_hz


def design(cfg: dict) -> dict:
    """The lowpass h, its group delay gc, the offsets and the decimation
    of a configuration file's `frontend` section."""
    fe = cfg["frontend"]
    fs = float(fe["sample_rate_hz"])
    decim = int(fe["decimation"])
    if fe["kind"] == "ddc":
        taps_d = decimation_fir(decim, fe["decim_taps_per_phase"])
        taps_c = channel_fir(fe["channel_taps"],
                             (fe["channel_bandwidth_hz"] / 2)
                             / (fs / decim / 2))
        up = np.zeros((len(taps_c) - 1) * decim + 1)
        up[::decim] = taps_c
        h = np.convolve(taps_d, up)
        gc = (len(taps_c) // 2) * decim + (len(taps_d) - 1) // 2
        offsets = carrier_grid(fe["carriers"])
    elif fe["kind"] == "pfb":
        from scipy.signal import firwin
        n_ch = int(round(fs / fe["channel_spacing_hz"]))
        h = firwin(n_ch * fe["taps_per_branch"], 1.0 / n_ch)
        gc = 0
        offsets = channel_offsets(n_ch, fs)
    else:
        raise ValueError(f"unknown frontend kind {fe['kind']!r}")
    return {"h": np.asarray(h, np.float64), "gc": int(gc), "decim": decim,
            "offsets": np.asarray(offsets, np.float64), "fs": fs,
            "k": int(fe["num_candidates"]),
            "threshold": float(fe["threshold"])}


# ---------------------------------------------------------- channelizer

def _fft_len(n: int) -> int:
    """Smallest 2^a 3^b >= n."""
    best = 1 << max(0, (n - 1).bit_length())
    p3 = 1
    while p3 < best:
        p2 = p3 << max(0, (-(-n // p3) - 1).bit_length())
        best = min(best, p2)
        p3 *= 3
    return best


def quantize(v: torch.Tensor, dtype) -> torch.Tensor:
    """Round real v to `dtype` with one per-tensor scale that maps its
    largest magnitude onto the type's largest finite value."""
    top = float(torch.finfo(dtype).max)
    amax = float(v.abs().max()) or 1.0
    return (v * (top / amax)).to(dtype).to(v.dtype) * (amax / top)


def channelize(x, d: dict, rows=None, block: int = 16,
               operand_dtype=None) -> torch.Tensor:
    """x (N,) complex -> (C, ceil(N / D)) complex128 channels (module
    docstring).  `rows` picks carriers (all by default).  With
    `operand_dtype` (the precision control) the real and imaginary parts
    of x and of each modulated kernel are rounded to that type first."""
    x = torch.as_tensor(x).to(torch.complex128)
    dev = x.device
    n = x.shape[-1]
    h = torch.as_tensor(d["h"], dtype=torch.float64, device=dev)
    L = h.shape[0]
    decim, gc, fs = d["decim"], d["gc"], d["fs"]
    offs = d["offsets"] if rows is None else d["offsets"][list(rows)]
    m_out = -(-n // decim)
    if operand_dtype is not None:
        x = torch.complex(quantize(x.real, operand_dtype),
                          quantize(x.imag, operand_dtype))
    nfft = _fft_len(n + L - 1 + decim)
    xf = torch.fft.fft(x, nfft)
    u = torch.arange(L, dtype=torch.float64, device=dev)
    k = torch.arange(m_out, dtype=torch.float64, device=dev) * decim + gc
    out = []
    for i in range(0, len(offs), block):
        f = torch.as_tensor(offs[i:i + block], dtype=torch.float64,
                            device=dev)[:, None]
        g = h * torch.polar(torch.ones_like(u), 2 * math.pi
                            * torch.remainder(f * u, fs) / fs)
        if operand_dtype is not None:
            g = torch.complex(quantize(g.real, operand_dtype),
                              quantize(g.imag, operand_dtype))
        full = torch.fft.ifft(xf * torch.fft.fft(g, nfft), nfft)
        y = full[:, gc:gc + m_out * decim:decim]
        rot = 2 * math.pi * torch.remainder(f * k, fs) / fs
        out.append(y * torch.polar(torch.ones_like(rot), -rot))
    return torch.cat(out)


# ---------------------------------------------------------------- demod

def phase_grid(y: torch.Tensor) -> tuple:
    """(C, M) channels -> ((C, S, 13) symbol grid, (C, 13) phase powers)
    over the S = M // 13 whole symbols."""
    s = y.shape[-1] // SPS
    grid = y[:, :s * SPS].reshape(y.shape[0], s, SPS)
    return grid, (grid.abs() ** 2).sum(dim=1)


def sector_of(z: torch.Tensor) -> torch.Tensor:
    """Dibit of each z by the quantizer's sectors (uint8)."""
    th = torch.angle(z)
    a = th.abs()
    d = torch.full(z.shape, 3, dtype=torch.uint8, device=z.device)
    d = torch.where((th < -3 * math.pi / 8) & (th > -5 * math.pi / 8), 2, d)
    d = torch.where((th > 3 * math.pi / 8) & (th < 5 * math.pi / 8), 1, d)
    d = torch.where(a <= 3 * math.pi / 8, 0, d)
    return torch.where(z == 0, 3, d).to(torch.uint8)


def sector_gap(z: torch.Tensor, dibit: torch.Tensor) -> torch.Tensor:
    """Distance from each z to the sector of `dibit` (0 inside it)."""
    centre = torch.tensor([s[0] for s in SECTORS], dtype=torch.float64,
                          device=z.device)[dibit.long()]
    half = torch.tensor([s[1] for s in SECTORS], dtype=torch.float64,
                        device=z.device)[dibit.long()]
    off = torch.remainder(torch.angle(z) - centre + math.pi,
                          2 * math.pi) - math.pi
    delta = (off.abs() - half).clamp_min(0.0)
    mag = z.abs()
    return torch.where(delta < math.pi / 2, mag * torch.sin(delta), mag)


def demod(y: torch.Tensor) -> tuple:
    """The reference's own decisions: (bits (C, 2(S-1)) uint8, count (C,)
    int, best phase (C,)), count the symbols at the best phase."""
    grid, power = phase_grid(y)
    best = torch.argmax(power, dim=-1)
    s = grid[torch.arange(grid.shape[0], device=y.device), :, best]
    d = sector_of(s[:, 1:] * s[:, :-1].conj())
    bits = torch.stack([(d >> 1) & 1, d & 1], dim=-1).reshape(d.shape[0], -1)
    count = torch.div(y.shape[-1] - best, SPS, rounding_mode="floor")
    return bits.to(torch.uint8), count, best


# ------------------------------------------------ sync, candidates, walk

def best_correlation(bits: np.ndarray) -> np.ndarray:
    """(C, B) bits -> (C, B - 21) float32: the larger of the TS1 and TS2
    match fractions at each start, (22 + sum of +-1 products) / 44."""
    pm = bits.astype(np.int32) * 2 - 1
    out = []
    for ts in (G.TS1, G.TS2):
        p = ts.astype(np.int32) * 2 - 1
        win = np.lib.stride_tricks.sliding_window_view(pm, G.SYNC_LEN_BITS,
                                                       axis=-1)
        s = (win * p).sum(-1)
        out.append(np.float32(22) + s.astype(np.float32))
    return np.maximum(*out) / np.float32(44.0)


def _crc_many(payload: np.ndarray) -> np.ndarray:
    a, c0 = G.crc_matrix(payload.shape[-1])
    return ((payload.astype(np.int64) @ a.T.astype(np.int64)) & 1) ^ c0


def candidates(bits: np.ndarray, corr: np.ndarray, count: np.ndarray,
               k: int, threshold: float) -> dict:
    """Top-k sync candidates of each row among the windows that fit a
    whole slot inside the valid bits (ties to the lower position; at
    ncorr / 128 >= 4k the top k of 128-wide segments' maxima), their
    510-bit windows and soft-CRC verdicts."""
    c, b = bits.shape
    ncorr = corr.shape[-1]
    valid_bits = np.maximum(count.astype(np.int64) - 1, 0) * 2
    pos = np.arange(ncorr)
    fits = ((pos >= G.SYNC_TO_FRAME_START_BITS)
            & (pos[None, :] - G.SYNC_TO_FRAME_START_BITS + G.BITS_PER_SLOT
               <= valid_bits[:, None]))
    masked = np.where(fits, corr, np.float32(-1.0)).astype(np.float32)
    n_seg = -(-ncorr // 128)
    if n_seg < 4 * k:
        order = np.argsort(-masked, axis=-1, kind="stable")[:, :k]
        top_pos = order
    else:
        padded = np.full((c, n_seg * 128), -1.0, np.float32)
        padded[:, :ncorr] = masked
        seg = padded.reshape(c, n_seg, 128)
        seg_arg = seg.argmax(-1)
        seg_max = seg.max(-1)
        top_seg = np.argsort(-seg_max, axis=-1, kind="stable")[:, :k]
        top_pos = top_seg * 128 + np.take_along_axis(seg_arg, top_seg, -1)
    top_corr = np.take_along_axis(masked, top_pos, -1)
    start = np.maximum(top_pos - G.SYNC_TO_FRAME_START_BITS, 0)
    win = np.minimum(start[..., None] + np.arange(G.BITS_PER_SLOT), b - 1)
    frames = np.take_along_axis(bits[:, None, :], win, -1)
    data = np.concatenate([frames[..., G.BURST_BLOCK1[0]:G.BURST_BLOCK1[1]],
                           frames[..., G.BURST_BLOCK2[0]:G.BURST_BLOCK2[1]]],
                          -1)
    payload, received = data[..., :-16], data[..., -16:]
    ones = data.sum(-1)
    err_f = (_crc_many(payload) != received).sum(-1)
    err_r = (_crc_many(payload[..., ::-1]) != received).sum(-1)
    crc_ok = (((ones != 0) & (ones != data.shape[-1]))
              & ((err_f <= G.CRC_SOFT_ERROR_BUDGET)
                 | (err_r <= G.CRC_SOFT_ERROR_BUDGET)))
    return {"cand_pos": top_pos.astype(np.int32), "cand_corr": top_corr,
            "cand_valid": top_corr >= np.float32(threshold),
            "frame_bits": frames.astype(np.uint8), "crc_ok": crc_ok}


def walk(corr: np.ndarray, threshold: float = 0.90) -> list:
    """The host decoder's greedy sync walk over one row's scores: the
    first position at or above `threshold`, then the next at least 250
    bits on, and so on."""
    hits = np.flatnonzero(corr >= threshold)
    out = []
    i = 0
    while True:
        j = np.searchsorted(hits, i)
        if j >= len(hits):
            return out
        out.append(int(hits[j]))
        i = int(hits[j]) + G.SYNC_SKIP_BITS
