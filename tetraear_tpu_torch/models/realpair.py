"""Real-pair demod tail (port of
`tetraear_tpu.models.realpair._demod_from_pair`): best-phase symbol
timing, the differential pi/4-DQPSK sector quantizer with the deferred
per-carrier rotation, and TS1/TS2 sync scores, on a (C, M) f32 channel
pair."""

from __future__ import annotations

from typing import NamedTuple

import torch

from tetraear_tpu_torch.ops import dqpsk, sync


class RealPairResult(NamedTuple):
    bits: torch.Tensor        # (C, B) uint8
    sync_corr: torch.Tensor   # (C, B-21) float32
    count: torch.Tensor       # (C,) int32
    best_phase: torch.Tensor  # (C,) int32


def _demod_from_pair(yr: torch.Tensor, yi: torch.Tensor, sps: int,
                     z_rot: tuple | None = None) -> RealPairResult:
    """Channel-rate (C, M) pair -> bits, sync scores, symbol count, phase.

    z_rot: optional per-carrier (cos, sin) tensors of the deferred
    residual rotation (ops.fused.symbol_rotation), applied to z.  As in
    the reference, z = 0 falls into bin 3 here."""
    m_dec = yr.shape[-1]
    m = m_dec // sps
    grid_r = yr[:, :m * sps].reshape(-1, m, sps)          # (C, M, sps)
    grid_i = yi[:, :m * sps].reshape(-1, m, sps)
    phase_power = (grid_r ** 2 + grid_i ** 2).sum(dim=1)  # (C, sps)
    best = torch.argmax(phase_power, dim=-1)              # first index on ties
    count = torch.div(m_dec - best, sps, rounding_mode="floor")

    # symbol pick at the best phase: a gather equals the reference's
    # one-hot einsum exactly (x*1 + 0*others)
    idx = best[:, None, None].expand(-1, m, 1)
    sym_r = torch.gather(grid_r, 2, idx)[..., 0]          # (C, M)
    sym_i = torch.gather(grid_i, 2, idx)[..., 0]

    zr = sym_r[:, 1:] * sym_r[:, :-1] + sym_i[:, 1:] * sym_i[:, :-1]
    zi = sym_i[:, 1:] * sym_r[:, :-1] - sym_r[:, 1:] * sym_i[:, :-1]
    if z_rot is not None:
        cd = z_rot[0][:, None]
        sd = z_rot[1][:, None]
        zr, zi = zr * cd + zi * sd, zi * cd - zr * sd
    hard = dqpsk.quantize_z_ref(zr, zi)
    bits = dqpsk.symbols_to_bits(hard)
    corr = sync.best_correlation(bits)
    return RealPairResult(bits, corr, count.to(torch.int32),
                          best.to(torch.int32))
