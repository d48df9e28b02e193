"""TS1/TS2 burst-sync correlation at every bit position (port of
`tetraear_tpu.ops.sync`): one 2-output-channel conv of the ±1-mapped bit
stream against the ±1 training sequences.  Every sum is an integer of
magnitude <= 22, exact in f32 (and in TF32), so the scores are exact."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from tetraear_tpu_torch import constants as C

_PATTERNS = np.stack([C.TS1, C.TS2]).astype(np.float32) * 2.0 - 1.0  # (2, 22)


def sync_correlation(bits: torch.Tensor) -> torch.Tensor:
    """bits (..., N) in {0, 1} -> (..., 2, N-21) f32 match fractions in
    [0, 1] (index 0 = TS1, 1 = TS2); an empty last axis for N < 22."""
    L = C.SYNC_LEN_BITS
    n = bits.shape[-1]
    if n < L:
        return torch.zeros(bits.shape[:-1] + (2, 0), dtype=torch.float32,
                           device=bits.device)
    x = bits.to(torch.float32) * 2.0 - 1.0
    rhs = torch.as_tensor(_PATTERNS, device=bits.device)[:, None, :]
    out = F.conv1d(x.reshape(-1, 1, n), rhs)             # (B, 2, N-L+1)
    corr = (L + out) / (2.0 * L)
    return corr.reshape(bits.shape[:-1] + (2, n - L + 1))


def best_correlation(bits: torch.Tensor) -> torch.Tensor:
    """Max over the two patterns: (..., N-21) f32."""
    return sync_correlation(bits).amax(dim=-2)
