"""TS1/TS2 burst-sync correlation at every bit position (port of
`tetraear_tpu.ops.sync`): one 2-output-channel conv of the ±1-mapped bit
stream against the ±1 training sequences.  Every sum is an integer of
magnitude <= 22, exact in f32 (and in TF32), so the scores are exact.

`sync_walk` then finds every row's sync hits in those scores at once,
where they lie: a hand-written kernel on the card, `sync_walk_plain` on
the CPU."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from tetraear_tpu_torch import constants as C
from tetraear_tpu_torch.ops.kernels import sync_walk as kernel

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


def sync_walk_plain(corr: torch.Tensor, count: torch.Tensor) -> tuple:
    """The sync walk of every row of a frontend result, the plain version
    of `ops/kernels/sync_walk` with its contract: corr (R, W) float32
    best-of-TS1/TS2 scores, count (R,) valid symbols per row -> (positions
    (R, ceil(W / 250)) int32, the accepted sync bit positions of each row
    in order and -1 after them; accepted (R,) int32, how many).

    Row r's valid windows are [0, V), V = min(W, 2 max(count - 1, 0) -
    21), the ones `MulticarrierDecoder` hands `TetraDecoder.frontend_walk`.
    With M their largest score read as float64, the walk's thresholds
    (`TetraDecoder.walk`: passes at 0.90, 0.85 and 0.80, then one at an
    adaptive threshold; each pass a `find_sync`) give exactly the greedy
    walk at

        0.90                    if M >= 0.90,
        max(0.75, M - 0.02)     if 0.75 <= M < 0.90,
        no walk (no sync)       if M < 0.75 or V = 0 (a row under 22 bits),

    every comparison `float64(score) >= threshold`.  The greedy walk
    takes the first window at or above the threshold, then the first at
    or after that position + 250 (SYNC_SKIP_BITS), and so on.

    Why.  `frontend_walk` hands `walk` (best, best) as the dense pair,
    and every observable of `find_sync` depends only on the larger of
    the two, so the pair is one score row.  The 0.90 pass finds a sync
    iff M >= 0.90, and then it is the greedy walk at 0.90.  Otherwise it
    visited every window, so its max_corr is M (or 0 if M < 0); if M >
    0.75 (and M >= 0.90 - 0.15 = 0.75) its in-pass adaptive re-walk runs
    at max(0.75, M - 0.02) < 0.90, which M itself meets, and that
    re-walk, each hit taken once it lies 250 past the last, is the
    greedy walk; the cascade stops there.  If M <= 0.75 nothing is found
    at 0.85 or 0.80 and no adaptive re-walk runs (it needs M > 0.75);
    the last pass runs at max(0.75, M - 0.02) = 0.75 if M >= 0.75 (M =
    0.75: the greedy walk at 0.75) and not at all if M < 0.75.  (0.90 -
    0.15 is 0.75 exactly in float64.)  The scores are finite (matches
    over 22).

    `walk` then keeps a hit whose slot starts inside the row (start = pos
    - 216 >= 0, start // 2 + 255 <= the row's symbols); the caller does
    that, as it knows the symbols.  In numpy: every row's M and
    threshold at once, each row's hits by one float32 comparison against
    the least float32 at or above its threshold (the same test as the
    float64 one), the walk from accept to accept by binary search."""
    s = corr.detach().cpu().numpy()
    r, w = s.shape
    cap = -(-w // C.SYNC_SKIP_BITS)
    nsym = np.maximum(count.detach().cpu().numpy().astype(np.int64) - 1, 0)
    valid = np.clip(2 * nsym - (C.SYNC_LEN_BITS - 1), 0, w)
    m = np.array([s[i, :v].max() if v else -np.inf
                  for i, v in enumerate(valid)], np.float64)
    high = C.SYNC_THRESHOLDS[0]
    thr = np.where(m >= high, high,
                   np.maximum(C.SYNC_ADAPTIVE_FLOOR,
                              m - C.SYNC_ADAPTIVE_TOLERANCE))
    least = thr.astype(np.float32)
    least = np.where(least.astype(np.float64) < thr,
                     np.nextafter(least, np.float32(np.inf)), least)
    positions = np.full((r, cap), -1, np.int32)
    accepted = np.zeros(r, np.int32)
    for i in np.flatnonzero(m >= C.SYNC_ADAPTIVE_FLOOR):
        hits = np.flatnonzero(s[i, :valid[i]] >= least[i])
        j = n = 0
        while j < len(hits):
            positions[i, n] = hits[j]
            n += 1
            j = np.searchsorted(hits, hits[j] + C.SYNC_SKIP_BITS)
        accepted[i] = n
    return torch.from_numpy(positions), torch.from_numpy(accepted)


def sync_walk(corr: torch.Tensor, count: torch.Tensor) -> tuple:
    """`sync_walk_plain`'s walk where the scores lie: one launch of the
    kernel (`ops/kernels/sync_walk`, `csrc/sync_walk.cu`) for a CUDA
    tensor, whose wrapper raises on what it does not take, and the plain
    version for a CPU tensor.  -> (positions, accepted) on that device."""
    if corr.device.type == "cuda":
        return kernel.sync_walk(corr, count)
    if corr.device.type != "cpu":
        raise ValueError(f"sync_walk: scores on {corr.device}; a CUDA "
                         "or a CPU tensor")
    return sync_walk_plain(corr, count)
