"""The comparison that decides `correct`: the numbers compared between
what the timed path produced and the plain reference, each beside its
limit.

Each row's symbol phase is the one, of those its symbol count allows,
that best explains the program's bits (the fewest decisions unlike the
reference's there, the least power short of the row's best).
- `demod_gap`: the widest gap by which the program's demodulated answers
  lie off the reference's: per row, how far the reference's power at
  that phase falls below its best phase's (over the median best-phase
  power of the carriers with traffic), plus the widest distance, over
  the row's symbols, of the reference's z at that phase outside the
  sector of the dibit the program decided (over the median |z| of the
  carriers with traffic); the largest over rows.
- `flip_share`: of the valid symbols of every row, the share whose dibit
  differs from the reference's decision at that phase.
- `stage_diff`: entries of the program's sync scores and candidates
  (positions, scores as matching bits, validity, windows, CRC verdicts)
  that differ from the reference's stage run on the program's own bits
  and counts.  Exact.
- `frames_diff`: slots, on carriers with traffic, that the host's sync
  walk reaches and that arrived with every bit intact, whose frame is
  missing or does not carry the planted type and text.  Exact.  A slot
  whose middle looks like a sync word is read by the host as a sync
  burst (the reference decoder's rule) and is not held to its text.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark import golden as G
from benchmark import reference as R

EXACT = ("stage_diff", "frames_diff")


def demod_gap(y: torch.Tensor, bits: np.ndarray, count: np.ndarray,
              busy, block: int = 8) -> tuple:
    """(demod_gap, flipped, symbols) of decisions (bits, count) on the
    reference's channels y (C, M).  Each row's phase is the one of those
    its count allows that best explains its bits: the least sum of the
    share of its decisions that differ from the reference's there and of
    its power's shortfall from the row's best.  At that phase, per row,
    the power gap plus the widest sector gap (both over the busy rows'
    medians), the largest over rows; and the decisions that differ from
    the reference's, of the valid symbols, over all rows."""
    grid, power = R.phase_grid(y)
    n_rows, s, _ = grid.shape
    dev = y.device
    busy = list(busy)
    bits_t = torch.as_tensor(bits[:, :2 * (s - 1)], device=dev).long()
    dib = ((bits_t[:, 0::2] << 1) | bits_t[:, 1::2]).to(torch.uint8)
    count_t = torch.as_tensor(count, device=dev).long()
    valid = (torch.arange(s - 1, device=dev)[None, :]
             < (count_t - 1)[:, None])
    phases = torch.arange(R.SPS, device=dev)
    allowed = ((y.shape[-1] - phases)[None, :] // R.SPS) == count_t[:, None]
    best = power.amax(dim=-1, keepdim=True)
    ref = grid[torch.arange(n_rows, device=dev), :, power.argmax(dim=-1)]
    z_scale = (ref[:, 1:] * ref[:, :-1].conj()).abs()[busy][valid[busy]]
    z_scale = z_scale.median()
    short = best - power                                        # (C, 13)
    z_gap = torch.empty_like(short)
    miss = torch.empty(short.shape, dtype=torch.long, device=dev)
    for i in range(0, n_rows, block):
        g = grid[i:i + block]
        z = g[:, 1:] * g[:, :-1].conj()                         # (b, S-1, 13)
        d = dib[i:i + block, :, None].expand_as(z)
        v = valid[i:i + block, :, None]
        gap = torch.where(v, R.sector_gap(z, d), 0.0)
        z_gap[i:i + block] = gap.amax(dim=1) / z_scale
        miss[i:i + block] = ((R.sector_of(z) != d) & v).sum(dim=1)
    n_valid = valid.sum(dim=1, keepdim=True).clamp_min(1)
    score = torch.where(allowed, miss / n_valid + short / best, torch.inf)
    phase = score.argmin(dim=-1)
    rows = torch.arange(n_rows, device=dev)
    gap = short[rows, phase] / best[busy].median() + z_gap[rows, phase]
    # a count no phase allows: the whole scale, a plain failure
    gap = torch.where(allowed[rows, phase], gap, torch.ones_like(gap))
    return (float(gap.max()), int(miss[rows, phase].sum()),
            int(valid.sum()))


def matches(corr: np.ndarray) -> np.ndarray:
    """Sync scores as the number of the 22 bits that match: the card
    divides by 44 as a multiplication by its reciprocal, one rounding
    off the division."""
    return np.rint(np.asarray(corr, np.float64) * 44.0).astype(np.int64)


def sync_burst(slot: np.ndarray) -> bool:
    """The host parser reads a slot as a sync burst, and not as the
    normal burst it is, when more than 80 % of the 22 bits at its middle
    match a downlink sync word (protocol/parser.py _detect_burst_type)."""
    mid = slot[G.BITS_PER_SLOT // 2:G.BITS_PER_SLOT // 2 + G.SYNC_LEN_BITS]
    return max(np.mean(mid == G.TS1),
               np.mean(mid == G.SYNC_DISCONTINUOUS)) > 0.8


def stage_diff(prog: dict, k: int, threshold: float) -> int:
    """Mismatched entries of the program's sync scores and candidates
    against the reference's stage on the program's bits and counts."""
    corr = R.best_correlation(prog["bits"])
    n = int((matches(corr) != matches(prog["sync_corr"])).sum())
    cand = R.candidates(prog["bits"], corr, prog["count"], k, threshold)
    n += int((matches(cand["cand_corr"])
              != matches(prog["cand_corr"])).sum())
    for key in ("cand_pos", "cand_valid", "crc_ok"):
        n += int((cand[key] != prog[key]).sum())
    n += int((cand["frame_bits"] != prog["frame_bits"]).any(-1).sum())
    return n


def frames_diff(prog: dict, frames: list, slots: dict) -> tuple:
    """(wrong, due): of the planted slots the host's walk reaches whole
    and intact, those whose frame is missing or carries another type or
    text."""
    corr = R.best_correlation(prog["bits"])
    wrong = due = 0
    for row, texts in slots.items():
        nbits = 2 * max(int(prog["count"][row]) - 1, 0)
        bits = prog["bits"][row]
        got = {f.get("sync_position"): f for f in frames[row]}
        for pos in R.walk(corr[row, :max(nbits - 21, 0)]):
            start = pos - G.SYNC_TO_FRAME_START_BITS
            if start < 0 or start + G.BITS_PER_SLOT > nbits:
                continue
            slot = bits[start:start + G.BITS_PER_SLOT]
            text = texts.get(slot.tobytes())
            if text is None or sync_burst(slot):
                continue
            due += 1
            f = got.get(pos)
            if f is None or f.get("type") != 0 or \
                    f.get("sds_message") != text:
                wrong += 1
    return wrong, due


def judge(numbers: dict, limits: dict) -> tuple:
    """(correct, lines): every number against its limit (an exact number's
    limit is 0); a number without a limit fails."""
    lines = []
    ok = True
    for name, value in numbers.items():
        limit = 0 if name in EXACT else limits.get(name)
        good = limit is not None and value <= limit
        ok &= good
        lines.append((name, value, limit, good))
    return ok, lines
