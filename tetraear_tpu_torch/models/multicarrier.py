"""Multicarrier full decode (BASELINE config 4) and the full-band PFB
decode, port of `tetraear_tpu.models.multicarrier`: one wideband IQ
block -> per-carrier bits, dense sync scores and fixed-K frame candidates
with soft-CRC verdicts, with only MAC/SDS parsing left to the host.

Stages of `MulticarrierFrontend.forward`:
  1. the composite s2d conv (mixer + decimating FIR + channel FIR), by
     the conv named in CONV_VARIANTS: a plain F.conv1d version or a
     hand-written kernel (K1, K1-of, K3);
  2. the real-pair demod tail (models.realpair._demod_from_pair);
  3. the candidates stage (extract_candidates): top-K sync positions,
     510-bit frame windows, batched soft CRC.
`PfbMulticarrierFrontend` runs the same stages over all 96 channels of
the 25 kHz grid at 2.4 MS/s, its conv the polyphase filterbank as one
dense conv (`ops.fused.pfb_kernel`, 192 rows).  `MulticarrierDecoder` is
the host decode over either result.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tetraear_tpu import constants as C
from tetraear_tpu.config import ReceiverConfig
from tetraear_tpu_torch.ops import fused, pfb
from tetraear_tpu_torch.ops.crc import crc_tables, soft_crc_check_batch
from tetraear_tpu_torch.ops.kernels.s2d_conv import (
    check_fold, parse_fold, s2d_conv, s2d_conv_db, s2d_conv_of,
    s2d_conv_of_plain, s2d_conv_plain)
from tetraear_tpu_torch.models.realpair import _demod_from_pair

class ConvVariant(NamedTuple):
    runs: str    # what runs the composite conv
    cli: bool    # a --conv choice of the reference's CLI
    pfb: bool    # a variant of the reference's PfbMulticarrierFrontend


# conv name -> ConvVariant; the names keep the reference's.  <N> is a
# fold (2D * N <= 128).  The frontends and the CLI read this table.
CONV_VARIANTS = {
    "s2d": ConvVariant("plain F.conv1d, f32", cli=True, pfb=True),
    "s2d_of": ConvVariant("plain F.conv1d with fold = max(1, min(8, "
                          "128 // C2)) output positions folded into rows, "
                          "f32", cli=True, pfb=False),
    "pallas": ConvVariant("K1 (csrc/s2d_conv.cu), f32 operands",
                          cli=True, pfb=True),
    "pallas_bf16": ConvVariant("K1 (csrc/s2d_conv.cu), bf16 operands, f32 "
                               "accumulation", cli=True, pfb=True),
    "pallas_db": ConvVariant("K3 (csrc/s2d_conv_db.cu): K1 with the next "
                             "tile's input prefetched by cp.async, f32",
                             cli=False, pfb=True),
    "pallas_of<N>": ConvVariant("K1-of (csrc/s2d_conv.cu, fold N), f32 "
                                "operands", cli=False, pfb=False),
    "pallas_of<N>_bf16": ConvVariant("K1-of (csrc/s2d_conv.cu, fold N), "
                                     "bf16 operands, f32 accumulation",
                                     cli=False, pfb=False),
}
PFB_CONV_VARIANTS = tuple(k for k, v in CONV_VARIANTS.items() if v.pfb)

_SEG = 128   # segment of the hierarchical top-K


class MulticarrierResult(NamedTuple):
    bits: torch.Tensor        # (C, B) uint8 demodulated bit streams
    sync_corr: torch.Tensor   # (C, B-21) float32 best-of-TS1/TS2
    count: torch.Tensor       # (C,) int32 valid symbol count per carrier
    cand_pos: torch.Tensor    # (C, K) int32 candidate sync bit positions
    cand_corr: torch.Tensor   # (C, K) float32 candidate correlations
    cand_valid: torch.Tensor  # (C, K) bool — corr >= threshold & in-bounds
    frame_bits: torch.Tensor  # (C, K, 510) uint8 candidate frame windows
    crc_ok: torch.Tensor      # (C, K) bool — soft-CRC verdict


def _top_k(x: torch.Tensor, k: int) -> tuple:
    """Largest k along the last axis, ties to the lower index (as
    lax.top_k): a stable descending sort, then the first k."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def extract_candidates(bits: torch.Tensor, corr: torch.Tensor,
                       valid_bits: torch.Tensor, k: int, threshold: float,
                       crc_a: torch.Tensor, crc_c0: torch.Tensor) -> tuple:
    """Top-K sync candidates + 510-bit frame windows + batched soft CRC.

    bits (C, B), corr (C, B-21), valid_bits (C,) valid bits per row;
    (crc_a, crc_c0) = ops.crc.crc_tables(200, device).  Returns (pos,
    corr, valid, frames, crc_ok)."""
    b = bits.shape[-1]
    ncorr = corr.shape[-1]
    pos_idx = torch.arange(ncorr, device=corr.device)
    # a window starting at p covers bits [p-216, p-216+510)
    in_bounds = ((pos_idx >= C.SYNC_TO_FRAME_START_BITS)
                 & (pos_idx[None, :] - C.SYNC_TO_FRAME_START_BITS
                    + C.BITS_PER_SLOT <= valid_bits[:, None]))
    masked = torch.where(in_bounds, corr, -1.0)
    n_seg = -(-ncorr // _SEG)
    if n_seg < 4 * k:
        top_corr, top_pos = _top_k(masked, k)
    else:
        # hierarchical top-K: segment maxima (first index on ties), top-K
        # over the segments, then the in-segment argmax.  True syncs are
        # >= 510 bits apart, so a segment holds at most one.
        padded = F.pad(masked, (0, n_seg * _SEG - ncorr), value=-1.0)
        seg_max, seg_arg = padded.reshape(-1, n_seg, _SEG).max(dim=-1)
        top_corr, top_seg = _top_k(seg_max, k)
        top_pos = top_seg * _SEG + torch.gather(seg_arg, -1, top_seg)
    start = (top_pos - C.SYNC_TO_FRAME_START_BITS).clamp_min(0)
    # clamped gather bits[c, min(start + j, b - 1)]
    win = (start[..., None]
           + torch.arange(C.BITS_PER_SLOT, device=bits.device)).clamp_max(b - 1)
    frames = torch.gather(bits, -1, win.reshape(win.shape[0], -1)
                          ).reshape(win.shape)
    valid = top_corr >= threshold
    data_bits = torch.cat(
        [frames[..., C.BURST_BLOCK1[0]:C.BURST_BLOCK1[1]],
         frames[..., C.BURST_BLOCK2[0]:C.BURST_BLOCK2[1]]], dim=-1)
    crc_ok = soft_crc_check_batch(data_bits, crc_a, crc_c0)
    return top_pos.to(torch.int32), top_corr, valid, frames, crc_ok


def conv_fold(conv: str, c2: int, decim: int) -> tuple:
    """conv name -> (fold, bf16): fold 0 for the un-folded convs.  An
    unknown name or a fold K1-of does not take raises."""
    if conv.startswith("pallas_of"):
        fold, bf16 = parse_fold(conv, "pallas_of")
        check_fold(fold, decim)
        return fold, bf16
    if conv == "s2d_of":
        return max(1, min(8, 128 // c2)), False
    if conv not in CONV_VARIANTS or "<" in conv:
        raise ValueError(f"unknown conv variant {conv!r}; valid: "
                         + ", ".join(CONV_VARIANTS))
    return 0, conv == "pallas_bf16"


@dataclass(frozen=True)
class FrontendState:
    """What the frontend convolves and rotates with: the (C2, 2D, Lp) s2d
    kernel, its composite length L and group delay gc, the decimation D,
    and the per-carrier (cos, sin) of the deferred z rotation.  The
    folded convs fold this kernel (ops.fused.fold_s2d_kernel), so every
    conv of both packages convolves with the identical kernel."""
    kernel_s2d: np.ndarray
    gc: int
    L: int
    decim: int
    z_cos: np.ndarray
    z_sin: np.ndarray


def state_from_reference(kernel, gc: int, rot_cycles, decim: int,
                         sps: int) -> FrontendState:
    """FrontendState from the (kernel, gc, rot_cycles) triple that
    `tetraear_tpu.ops.fused.fused_kernel` (or this package's copy)
    returns, so that both packages convolve with the identical kernel."""
    kernel = np.asarray(kernel, np.float32)
    z_cos, z_sin = fused.symbol_rotation(np.asarray(rot_cycles), decim, sps)
    return FrontendState(fused.s2d_kernel(kernel, decim), int(gc),
                         kernel.shape[-1], decim, z_cos, z_sin)


class MulticarrierFrontend(nn.Module):
    """Device pipeline for one carrier-offset set: composite conv ->
    demod tail -> candidates.  Buffers: the s2d kernel (and its folded
    form for the folded convs), the z rotation (cos, sin) and the CRC
    matrix.  `conv` names a CONV_VARIANTS entry."""

    def __init__(self, state: FrontendState, *, sps: int, device,
                 num_candidates: int = 64, threshold: float = 0.80,
                 conv: str = "pallas_bf16"):
        super().__init__()
        self.fold, self.bf16 = conv_fold(conv, state.kernel_s2d.shape[0],
                                         state.decim)
        self.conv = conv
        self.gc, self.L, self.decim = state.gc, state.L, state.decim
        self.sps = sps
        self.num_candidates = num_candidates
        self.threshold = threshold
        device = torch.device(device)
        self.register_buffer("kernel_s2d", torch.as_tensor(
            state.kernel_s2d, dtype=torch.float32, device=device))
        if self.fold:
            self.register_buffer("kernel_of", torch.as_tensor(
                fused.fold_s2d_kernel(state.kernel_s2d, self.fold),
                device=device))
        self.register_buffer("z_cos", torch.as_tensor(state.z_cos,
                                                      device=device))
        self.register_buffer("z_sin", torch.as_tensor(state.z_sin,
                                                      device=device))
        crc_a, crc_c0 = crc_tables(
            (C.BURST_BLOCK1[1] - C.BURST_BLOCK1[0])
            + (C.BURST_BLOCK2[1] - C.BURST_BLOCK2[0]) - 16, device)
        self.register_buffer("crc_a", crc_a)
        self.register_buffer("crc_c0", crc_c0)

    @classmethod
    def from_offsets(cls, offsets_hz, config: ReceiverConfig | None = None,
                     **kwargs) -> "MulticarrierFrontend":
        """Build the composite kernel for `offsets_hz` with this package's
        designers (the reference's `_fused_stages` recipe)."""
        cfg = config or ReceiverConfig()
        decim = cfg.decimation_factor
        cutoff = ((cfg.channel_bandwidth_hz / 2)
                  / (cfg.intermediate_rate_hz / 2))
        kernel, gc, rot = fused.fused_kernel(
            np.asarray(offsets_hz, np.float64), cfg.sample_rate_hz, decim,
            cfg.decim_fir_taps_per_phase, cfg.channel_fir_taps, cutoff)
        return cls.from_reference(kernel, gc, rot, cfg, **kwargs)

    @classmethod
    def from_reference(cls, kernel, gc: int, rot_cycles,
                       config: ReceiverConfig | None = None,
                       **kwargs) -> "MulticarrierFrontend":
        """Build from a (kernel, gc, rot_cycles) triple of fused_kernel."""
        cfg = config or ReceiverConfig()
        sps = cfg.ref_samples_per_symbol
        state = state_from_reference(kernel, gc, rot_cycles,
                                     cfg.decimation_factor, sps)
        return cls(state, sps=sps, **kwargs)

    @property
    def device(self) -> torch.device:
        return self.kernel_s2d.device

    def channelize(self, x: torch.Tensor) -> tuple:
        """(N,) complex64 on the module's device -> un-derotated (yr, yi)."""
        args = (self.gc, self.L, self.decim)
        if self.conv == "s2d":
            out = s2d_conv_plain(x, self.kernel_s2d, *args)
        elif self.conv == "s2d_of":
            out = s2d_conv_of_plain(x, self.kernel_of, *args, self.fold)
        elif self.conv == "pallas_db":
            out = s2d_conv_db(x, self.kernel_s2d, *args)
        elif self.fold:
            out = s2d_conv_of(x, self.kernel_of, *args, self.fold,
                              bf16=self.bf16)
        else:
            out = s2d_conv(x, self.kernel_s2d, *args, bf16=self.bf16)
        c = out.shape[0] // 2
        return out[:c], out[c:]

    def forward(self, x, start_index: int = 0) -> MulticarrierResult:
        """x: (N,) complex IQ (numpy or tensor), moved to the module's
        device.  `start_index` (the block's first sample index) is taken
        for parity with the reference's call: the rotation is deferred to
        z as a per-carrier constant, so the result does not depend on it."""
        x = torch.as_tensor(x, device=self.device).to(torch.complex64)
        yr, yi = self.channelize(x.contiguous())
        res = _demod_from_pair(yr, yi, self.sps,
                               z_rot=(self.z_cos, self.z_sin))
        valid_bits = (res.count - 1).clamp_min(0) * 2
        pos, ccorr, valid, frames, crc_ok = extract_candidates(
            res.bits, res.sync_corr, valid_bits, self.num_candidates,
            self.threshold, self.crc_a, self.crc_c0)
        return MulticarrierResult(res.bits, res.sync_corr, res.count, pos,
                                  ccorr, valid, frames, crc_ok)


class PfbMulticarrierFrontend(MulticarrierFrontend):
    """Full-band filterbank frontend (port of the reference's
    `PfbMulticarrierFrontend` for its s2d, pallas, pallas_bf16 and
    pallas_db variants): the polyphase DFT filterbank of all fs / 25 kHz
    channels (96 at 2.4 MS/s) as one dense conv of 2 x 96 rows, then the
    demod tail and candidates over every channel.  Row c is the channel
    at `channel_offsets_hz()[c]` (fftfreq order)."""

    def __init__(self, state: FrontendState, *, sample_rate_hz: float,
                 conv: str = "pallas_bf16", **kwargs):
        if conv not in PFB_CONV_VARIANTS:
            raise ValueError(f"unknown PFB conv variant {conv!r}; valid: "
                             + ", ".join(PFB_CONV_VARIANTS))
        super().__init__(state, conv=conv, **kwargs)
        self.sample_rate_hz = sample_rate_hz
        self.num_channels = state.kernel_s2d.shape[0] // 2

    @classmethod
    def from_config(cls, config: ReceiverConfig | None = None,
                    taps_per_branch: int = 8,
                    **kwargs) -> "PfbMulticarrierFrontend":
        """Build the filterbank kernel with this package's designers (the
        reference's constructor recipe)."""
        cfg = config or ReceiverConfig()
        num_channels = int(round(cfg.sample_rate_hz / 25e3))
        kernel, gc, rot = fused.pfb_kernel(num_channels, cfg.sample_rate_hz,
                                           taps_per_branch=taps_per_branch)
        return cls.from_reference(kernel, gc, rot, cfg, **kwargs)

    @classmethod
    def from_reference(cls, kernel, gc: int, rot_cycles,
                       config: ReceiverConfig | None = None,
                       **kwargs) -> "PfbMulticarrierFrontend":
        """Build from a (kernel, gc, rot_cycles) triple of pfb_kernel."""
        cfg = config or ReceiverConfig()
        return super().from_reference(kernel, gc, rot_cycles, cfg,
                                       sample_rate_hz=cfg.sample_rate_hz,
                                       **kwargs)

    def channel_offsets_hz(self) -> np.ndarray:
        """Center frequency of each channel row (fftfreq order)."""
        return pfb.channel_offsets_hz(self.num_channels, self.sample_rate_hz)


class MulticarrierDecoder:
    """Host decode over MulticarrierResult: one stateful TetraDecoder per
    carrier, fed from the device bit streams and dense sync scores."""

    def __init__(self, num_carriers: int, auto_decrypt: bool = False):
        from tetraear_tpu_torch.hostref import tetra_decoder_class
        decoder_cls = tetra_decoder_class()
        self.decoders = [decoder_cls(auto_decrypt=auto_decrypt)
                         for _ in range(num_carriers)]

    def decode(self, result: MulticarrierResult) -> list:
        """-> list of per-carrier frame lists; frames gain a 'carrier' key."""
        bits = result.bits.cpu().numpy()
        corr = result.sync_corr.cpu().numpy()
        counts = result.count.cpu().numpy()
        out = []
        for c, dec in enumerate(self.decoders):
            nsym = max(int(counts[c]) - 1, 0)
            nbits = 2 * nsym
            cbits = bits[c, :nbits]
            mapped = (cbits[0::2].astype(np.int64) << 1) | cbits[1::2]
            ncorr = max(0, nbits - 21)
            frames = dec.decode_frontend(cbits, mapped, corr[c, :ncorr])
            for f in frames:
                f["carrier"] = c
            out.append(frames)
        return out
