"""The candidates stage shared by every multicarrier frontend (port of
`tetraear_tpu.models.multicarrier.extract_candidates`): top-K sync
positions per carrier, their 510-bit frame windows and batched soft-CRC
verdicts, as fixed-K tensors with validity masks."""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from tetraear_tpu import constants as C
from tetraear_tpu_torch.ops.crc import crc_tables, soft_crc_check_batch

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


def candidate_stage(bits: torch.Tensor, corr: torch.Tensor,
                    count: torch.Tensor, k: int, threshold: float,
                    crc_a: torch.Tensor, crc_c0: torch.Tensor
                    ) -> MulticarrierResult:
    """extract_candidates over the valid bits of `count` symbols per row
    -> the full MulticarrierResult."""
    valid_bits = (count - 1).clamp_min(0) * 2
    return MulticarrierResult(bits, corr, count, *extract_candidates(
        bits, corr, valid_bits, k, threshold, crc_a, crc_c0))


class CandidateStage(nn.Module):
    """Base of the frontends: the samples per symbol, the candidate
    budget K and threshold, and the CRC matrix as buffers (crc_a,
    crc_c0) on the module's device."""

    def __init__(self, *, sps: int, device, num_candidates: int = 64,
                 threshold: float = 0.80):
        super().__init__()
        self.sps = sps
        self.num_candidates = num_candidates
        self.threshold = threshold
        crc_a, crc_c0 = crc_tables(
            (C.BURST_BLOCK1[1] - C.BURST_BLOCK1[0])
            + (C.BURST_BLOCK2[1] - C.BURST_BLOCK2[0]) - 16,
            torch.device(device))
        self.register_buffer("crc_a", crc_a)
        self.register_buffer("crc_c0", crc_c0)

    @property
    def device(self) -> torch.device:
        return self.crc_a.device

    def candidates(self, bits: torch.Tensor, corr: torch.Tensor,
                   count: torch.Tensor) -> MulticarrierResult:
        """The candidates stage over a demod result -> MulticarrierResult."""
        return candidate_stage(bits, corr, count, self.num_candidates,
                               self.threshold, self.crc_a, self.crc_c0)
