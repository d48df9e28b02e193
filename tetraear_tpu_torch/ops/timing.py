"""Symbol timing by best-phase pick (port of `tetraear_tpu.ops.timing`):
among the sampling phases p in {0, step, 2 step, ...} choose the one of
largest mean |x[p::sps]|^2 (the first maximum wins), then sample on that
grid.  Fixed shapes: a symbol array of capacity ceil(N/sps), zero past
the winning phase's `count`."""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F


class TimedSymbols(NamedTuple):
    symbols: torch.Tensor     # (..., M) complex64, zero-padded past `count`
    count: torch.Tensor       # (...,) int32 valid symbols
    best_phase: torch.Tensor  # (...,) int32


def best_phase_pick(x: torch.Tensor, sps: int, step: int | None = None
                    ) -> TimedSymbols:
    """x: (..., N) complex -> symbols sampled at the best phase.  Phase p
    owns (N - p)//sps samples, which can leave out up to two real
    trailing samples of the (M, sps) grid besides its zero padding: their
    power is taken back out of the sums, as the reference does."""
    n = x.shape[-1]
    lead = x.shape[:-1]
    if sps <= 1:
        return TimedSymbols(x.to(torch.complex64),
                            torch.full(lead, n, dtype=torch.int32,
                                       device=x.device),
                            torch.zeros(lead, dtype=torch.int32,
                                        device=x.device))
    if step is None:
        step = max(1, sps // 8)
    dev = x.device
    m = -(-n // sps)
    phases = torch.arange(0, sps, step, device=dev)
    counts = torch.div(n - phases, sps, rounding_mode="floor")
    grid = F.pad(x, (0, m * sps - n)).reshape(*lead, m, sps)
    power = grid.abs() ** 2
    power_sums = power.sum(dim=-2)                         # (..., sps)
    r0 = max(m - 2, 0)
    k_tail = torch.arange(r0, m, device=dev)[:, None]
    counts_full = torch.div(n - torch.arange(sps, device=dev), sps,
                            rounding_mode="floor")
    invalid = k_tail >= counts_full[None, :]
    power_sums = power_sums - torch.where(
        invalid, power[..., r0:, :], 0.0).sum(dim=-2)
    mean_power = (power_sums[..., ::step]
                  / counts.clamp_min(1).to(torch.float32))
    # phases with no symbols are skipped, as the reference's `continue`
    mean_power = torch.where(counts > 0, mean_power, -torch.inf)
    best = torch.argmax(mean_power, dim=-1)                # first max wins
    best_phase = phases[best]
    count = torch.div(n - best_phase, sps, rounding_mode="floor")
    idx = best_phase[..., None, None].expand(*lead, m, 1)
    sym = torch.gather(grid, -1, idx)[..., 0]
    k = torch.arange(m, device=dev)
    sym = torch.where(k < count[..., None], sym, torch.zeros_like(sym))
    return TimedSymbols(sym.to(torch.complex64), count.to(torch.int32),
                        best_phase.to(torch.int32))
