"""The plain reference of the ETSI downlink decode, in float64 PyTorch,
written from ETSI EN 300 392-2 and independent of the program: it imports
nothing of tetraear_tpu_torch, designs its own matched filter and builds
its own channel codes, and takes from the program only what a check
hands it (the program's soft bits, to decode them again).

Demodulation (clauses 5.2-5.3): pi/4-DQPSK at 18 ksym/s, the
transmitter's root-raised-cosine filter of roll-off 0.35.  For a chunk x
at 2.4 MS/s the reference applies the matched filter's exact frequency
response in one FFT product (zero outside +-(1 + 0.35) 9 kHz, so nothing
of the band beyond the channel enters), reads the filtered signal at 72
kHz (4 samples a symbol) by a phase ramp per fractional offset, samples
at the phase of the four with the most mean power, and gives each symbol
pair z[k] = s[k + 1] conj(s[k]) the soft bits (-sin dphi, -cos dphi),
dphi = arg z[k] (Table 5.1: 00 +pi/4, 01 +3pi/4, 10 -pi/4, 11 -3pi/4; +1
means bit 1).

Channel coding (clause 8), on soft bits, batched over a group's blocks:
descrambling by the 30-bit extended colour code's sequence (8.2.5),
block de-interleaving, (K, a) = (120, 11), (216, 101), (432, 103)
(8.2.4.1: b4(k) = b3(i), k = 1 + (a i mod K)), depuncturing of the
rate-2/3 code (8.2.3.1.3: t = 3, P = (1, 2, 5)) onto the rate-1/4 mother
code of constraint length 5 (8.2.3.1.1), a per-step Viterbi over its 16
states, the CRC-16 (8.2.3.3), and the AACH's shortened RM(30,14) code
(8.2.3.2) by correlation with all 16,384 codewords.

Departures from the EN, each a choice this reference shares with the
program's receiver or transmitter, where the EN sets no rule or its text
could not be checked here:
- The receiver's rules, which the EN leaves open: symbol timing by the
  largest mean power of the four phases; cell acquisition at the first
  position where 34 or more of the 38 STS bits match and the BSCH there
  decodes with its CRC passing; a burst read as a synchronization burst
  where its STS match beats both NTS matches by 8 bits or more; a
  Viterbi tie taken by the predecessor whose oldest input bit is 0; an
  RM(30,14) tie by the lower message value; the AACH header 3 read as a
  traffic slot, anything else as control (the EN reads the header
  together with the frame and field 1).
- The RM(30,14) generator is RM(2, 5) in reduced row echelon form with
  its last two information rows and their pivot columns deleted (the EN
  prints a systematic generator; it is not typed in from its table).
- Three points where the program's reading is followed because the EN's
  text is not in the repository to check it: the scrambling sequence
  starts with the 32 seed bits p(-31)..p(0) (1, 1, e30, ..., e1) before
  the recurrence's bits; the CRC's 16 parity bits are the remainder of
  the register preset to ones, not complemented; G3 = 1 + D + D^2 + D^3
  + D^4.  A fault that the program's transmitter and receiver share on
  one of these three would pass.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

FS = 2_400_000.0          # capture rate (the BladeRF's), samples/s
SYMBOL_RATE = 18_000.0    # clause 5
ROLL_OFF = 0.35           # clause 5, the RRC filter
SPS = 4                   # samples a symbol read from the filtered signal
SLOT = 510                # bits a timeslot (clause 9)
SLOTS_PER_FRAME, FRAMES_PER_MF, MF_PER_HF = 4, 18, 60

# training sequences (clause 9.4.4.3): the synchronization sequence y and
# the normal sequences n (NTS1) and p (NTS2)
STS = np.array([int(c) for c in "11000001100111001110100111010000110111"],
               np.uint8)
NTS1 = np.array([int(c) for c in "1101000011101001110100"], np.uint8)
NTS2 = np.array([int(c) for c in "0111101001000011011100"], np.uint8)
STS_MIN = 34              # of 38 STS bits, for acquisition
MID = 244                 # where the STS and the NTS start in a burst

# burst fields (clause 9.4.4.3), bit ranges of a 510-bit slot
SB1, SB_BB, BKN2 = (94, 214), (214, 244), (282, 498)
BKN1, NDB_BB1, NDB_BB2 = (14, 230), (230, 244), (266, 282)

# mother code, constraint length 5 (8.2.3.1.1): taps on u(k)..u(k-4)
GENERATORS = (0o31, 0o27, 0o37, 0o33)      # 1+D+D^4 (as u(k) = MSB), ...
# channel: (type-1 bits, interleaving K, a)
CHANNELS = {"BSCH": (60, 120, 11), "SCH/HD": (124, 216, 101),
            "STCH": (124, 216, 101), "SCH/F": (268, 432, 103)}
# scrambler polynomial (8.2.5): the exponents of c(x) past x^0
SCRAMBLER_TAPS = (1, 2, 4, 5, 7, 8, 10, 11, 12, 16, 22, 23, 26, 32)
CRC_POLY = 0x1021         # x^16 + x^12 + x^5 + 1 (8.2.3.3)


# ---------------------------------------------------------------- demod

def rrc_response(f: torch.Tensor) -> torch.Tensor:
    """The root-raised-cosine's amplitude response at frequencies f (Hz),
    1 on the flat part, 0 past (1 + alpha) / 2T."""
    t = 1.0 / SYMBOL_RATE
    lo = (1 - ROLL_OFF) / (2 * t)
    hi = (1 + ROLL_OFF) / (2 * t)
    a = f.abs()
    edge = torch.cos(math.pi * t / (2 * ROLL_OFF) * (a - lo))
    return torch.where(a <= lo, torch.ones_like(a),
                       torch.where(a <= hi, edge, torch.zeros_like(a)))


def _rounded(x: torch.Tensor, dtype) -> torch.Tensor:
    """x with its values rounded to `dtype`, one scale for the tensor (its
    largest magnitude at the dtype's largest finite value); complex x by
    its real and imaginary parts."""
    if dtype is None:
        return x
    if x.is_complex():
        return torch.complex(_rounded(x.real, dtype), _rounded(x.imag, dtype))
    top = x.abs().max()
    if float(top) == 0.0:
        return x
    scale = torch.finfo(dtype).max / top
    return (x * scale).float().to(dtype).to(x.dtype) / scale


def demod(x, signal_dtype=None) -> torch.Tensor:
    """A chunk at 2.4 MS/s -> the soft bits (S - 1, 2) float64 of its S
    symbols.  `signal_dtype` rounds the filtered 72 kHz signal (one
    scale), as the precision control does: rounding the chunk itself
    would not show, since the matched filter keeps 25 kHz of the 2.4 MHz
    over which that rounding's error spreads."""
    dev = x.device if isinstance(x, torch.Tensor) else torch.device("cpu")
    x = torch.as_tensor(x, device=dev).to(torch.complex128)
    n = x.shape[0]
    step = FS / (SYMBOL_RATE * SPS)                 # 100 / 3 samples
    m = int((n - 1) // step) + 1                    # 72 kHz samples in x
    # zero padding on both sides: the FFT product is then the linear
    # filter (the response's taps die out within +-8 symbols)
    pad = 2048
    size = n + 2 * pad
    spec = torch.fft.fft(torch.nn.functional.pad(x, (pad, pad)))
    f = torch.fft.fftfreq(size, 1.0 / FS, dtype=torch.float64, device=dev)
    spec = spec * rrc_response(f)
    # the 72 kHz sample j sits at 2.4 MS/s position j * 100/3: its integer
    # part and one of three fractional offsets, read by a phase ramp
    j = torch.arange(m, device=dev)
    whole = torch.div(j * 100, 3, rounding_mode="floor")
    frac = (j * 100) % 3
    y = torch.empty(m, dtype=torch.complex128, device=dev)
    for r in range(3):
        ramp = torch.exp(2j * math.pi * f * (r / 3.0) / FS)
        full = torch.fft.ifft(spec * ramp)[pad:pad + n]
        pick = frac == r
        y[pick] = full[whole[pick]]
    y = _rounded(y, signal_dtype)
    # timing: the phase of the four with the most mean power
    count = [(m - p + SPS - 1) // SPS for p in range(SPS)]
    power = torch.stack([y[p::SPS].abs().square().sum() / count[p]
                         for p in range(SPS)])
    phase = int(torch.argmax(power))
    s = y[phase::SPS]
    z = s[1:] * s[:-1].conj()
    dphi = torch.atan2(z.imag, z.real)
    return torch.stack([-torch.sin(dphi), -torch.cos(dphi)], dim=-1)


# ------------------------------------------------------ channel decoding

@functools.lru_cache(maxsize=64)
def scrambling_bits(ecc30: int, n: int) -> np.ndarray:
    """The scrambling sequence (8.2.5): p(k) = sum_i c_i p(k - i) mod 2,
    seeded with p(-31) = p(-30) = 1 and p(-29..0) = e30..e1 (e1 the MSB of
    the 30-bit extended colour code); n bits from p(-31) on."""
    seed = [1, 1] + [(ecc30 >> i) & 1 for i in range(30)]
    p = seed + [0] * max(0, n - 32)
    for k in range(32, n):
        v = 0
        for i in SCRAMBLER_TAPS:
            v ^= p[k - i]
        p[k] = v
    return np.array(p[:n], np.uint8)


def extended_colour_code(mcc: int, mnc: int, colour_code: int) -> int:
    """MCC (10 bits) | MNC (14) | colour code (6)."""
    return (mcc << 20) | (mnc << 6) | colour_code


@functools.lru_cache(maxsize=8)
def _deinterleave_index(k: int, a: int) -> np.ndarray:
    """b3(i) = b4(1 + (a i mod K)), 1-based; -> 0-based gather indices."""
    i = np.arange(1, k + 1)
    return (a * i) % k


@functools.lru_cache(maxsize=8)
def _depuncture_index(n_out: int) -> np.ndarray:
    """The mother-code position (0-based) of each of the n_out bits kept
    at rate 2/3: k = 8 ((j - 1) div 3) + P((j - 1) mod 3 + 1)."""
    j = np.arange(1, n_out + 1)
    p = np.array([1, 2, 5])
    return 8 * ((j - 1) // 3) + p[(j - 1) % 3] - 1


@functools.lru_cache(maxsize=1)
def _trellis():
    """Per state (the last four inputs, u(k-1) the MSB) and input u: the
    next state and the four coded bits' signs, +1 for a 1."""
    nxt = np.zeros((16, 2), np.int64)
    sign = np.zeros((16, 2, 4), np.float64)
    for s in range(16):
        for u in (0, 1):
            reg = (u << 4) | s                   # u(k) .. u(k-4), MSB first
            for g, taps in enumerate(GENERATORS):
                sign[s, u, g] = 1.0 if bin(reg & taps).count("1") % 2 else -1.0
            nxt[s, u] = reg >> 1
    return nxt, sign


def viterbi(llr: torch.Tensor, n_in: int, metric_dtype=torch.float64,
            fixed: torch.Tensor | None = None) -> tuple:
    """(B, 4 n_in) mother-code soft bits -> ((B, n_in - 4) inputs of the
    path that ends in state 0, the 4 tail bits stripped; (B,) its path
    metric).  A path metric is the sum of soft value x sign over the
    path, kept in `metric_dtype`; each step each state keeps its better
    predecessor, the one whose oldest input is 0 on a tie.  `fixed` (B,
    F) holds the first F inputs to those bits (the best path among those
    that start so)."""
    nxt, sign = _trellis()
    dev = llr.device
    b = llr.shape[0]
    x = llr.reshape(b, n_in, 4).to(torch.float64)
    # predecessors of state t: (t << 1) & 15 | o, o the oldest input; the
    # input that led there is t >> 3
    t = np.arange(16)
    preds = [((t << 1) & 15) | o for o in (0, 1)]
    ins = t >> 3
    for o in (0, 1):
        assert (nxt[preds[o], ins] == t).all()
    sg = [torch.as_tensor(sign[preds[o], ins], device=dev) for o in (0, 1)]
    pr = [torch.as_tensor(preds[o], device=dev) for o in (0, 1)]
    metric = torch.full((b, 16), -math.inf, dtype=metric_dtype, device=dev)
    metric[:, 0] = 0
    choice = torch.empty((n_in, b, 16), dtype=torch.bool, device=dev)
    into = torch.as_tensor(ins, device=dev)
    for k in range(n_in):
        cand = [metric[:, pr[o]] + (x[:, k, None, :] * sg[o][None]).sum(-1)
                .to(metric_dtype) for o in (0, 1)]
        take = cand[1] > cand[0]
        choice[k] = take
        metric = torch.where(take, cand[1], cand[0])
        if fixed is not None and k < fixed.shape[1]:
            metric = torch.where(into[None] == fixed[:, k, None].long(),
                                 metric, -math.inf)
    end = metric[:, 0]
    state = torch.zeros(b, dtype=torch.long, device=dev)
    bits = torch.empty((b, n_in), dtype=torch.uint8, device=dev)
    for k in range(n_in - 1, -1, -1):
        bits[:, k] = (state >> 3).to(torch.uint8)
        o = choice[k].gather(1, state[:, None])[:, 0].long()
        state = ((state << 1) & 15) | o
    return bits[:, :n_in - 4], end


def crc16(bits: torch.Tensor) -> torch.Tensor:
    """(B, K) bits -> (B, 16) parity bits: the remainder of the register
    preset to ones over the bits, MSB first (8.2.3.3)."""
    reg = torch.full((bits.shape[0],), 0xFFFF, dtype=torch.long,
                     device=bits.device)
    for k in range(bits.shape[1]):
        top = ((reg >> 15) & 1) ^ bits[:, k].long()
        reg = ((reg << 1) & 0xFFFF) ^ (top * CRC_POLY)
    return torch.stack([(reg >> (15 - i)) & 1 for i in range(16)],
                       dim=1).to(torch.uint8)


def mother_soft(soft: torch.Tensor, channel: str, ecc30: int
                ) -> torch.Tensor:
    """(B, K) type-5 soft bits -> (B, 4 n_in) float64 on the mother
    code's grid: descrambled, de-interleaved, depunctured (0 where a
    bit was not sent)."""
    k1, k, a = CHANNELS[channel]
    dev = soft.device
    x = soft.to(torch.float64)
    seq = torch.as_tensor(scrambling_bits(ecc30, k), device=dev)
    x = x * (1.0 - 2.0 * seq.to(torch.float64))
    x = x[:, torch.as_tensor(_deinterleave_index(k, a), device=dev)]
    mother = torch.zeros((x.shape[0], 4 * (k1 + 20)), dtype=torch.float64,
                         device=dev)
    mother[:, torch.as_tensor(_depuncture_index(k), device=dev)] = x
    return mother


def decode_channel(soft: torch.Tensor, channel: str, ecc30: int,
                   metric_dtype=torch.float64) -> tuple:
    """(B, K) type-5 soft bits of one channel -> (type-1 bits (B, K1),
    CRC verdict (B,))."""
    k1 = CHANNELS[channel][0]
    bits, _ = viterbi(mother_soft(soft, channel, ecc30), k1 + 20,
                      metric_dtype)
    data = bits[:, :k1]
    ok = (crc16(data) == bits[:, k1:k1 + 16]).all(dim=1)
    return data, ok


def path_gap(soft: torch.Tensor, channel: str, ecc30: int,
             data: torch.Tensor) -> tuple:
    """How far decoding to `data` (B, K1) falls short of the best path:
    (the best path metric less the best metric of a path that starts
    with `data`, (B,); that path's CRC verdict, (B,); the float32
    rounding of two path metrics, 2 n_in 2^-24 sum |soft|, (B,)).  A
    decoder that sums its path metrics in float32 can pick either of two
    paths whose metrics lie within the last."""
    k1 = CHANNELS[channel][0]
    mother = mother_soft(soft, channel, ecc30)
    _, best = viterbi(mother, k1 + 20)
    bits, held = viterbi(mother, k1 + 20, fixed=data)
    ok = (crc16(bits[:, :k1]) == bits[:, k1:k1 + 16]).all(dim=1)
    tol = 2 * (k1 + 20) * 2.0 ** -24 * mother.abs().sum(dim=1)
    return best - held, ok, tol


@functools.lru_cache(maxsize=1)
def rm_codewords() -> np.ndarray:
    """All 2^14 codewords of the shortened RM(30,14) code, (16384, 30),
    row m the codeword of message m (message bit 1 the MSB)."""
    pts = np.arange(32)
    v = [(pts >> i) & 1 for i in range(5)]
    rows = [np.ones(32, np.int64)] + v + [v[i] & v[j] for i in range(5)
                                           for j in range(i + 1, 5)]
    g = np.array(rows) % 2
    # reduced row echelon form over GF(2)
    pivots, r = [], 0
    for c in range(32):
        hit = [i for i in range(r, 16) if g[i, c]]
        if not hit:
            continue
        g[[r, hit[0]]] = g[[hit[0], r]]
        for i in range(16):
            if i != r and g[i, c]:
                g[i] ^= g[r]
        pivots.append(c)
        r += 1
        if r == 16:
            break
    keep = [c for c in range(32) if c not in pivots[14:]]
    gen = g[:14][:, keep]
    msgs = (np.arange(1 << 14)[:, None] >> np.arange(13, -1, -1)) & 1
    return (msgs @ gen) % 2


def rm_scores(soft: torch.Tensor) -> torch.Tensor:
    """(B, 30) soft bits -> (B, 16384) correlations with every codeword."""
    table = torch.as_tensor(rm_codewords(), dtype=torch.float64,
                            device=soft.device)
    return soft.to(torch.float64) @ (2.0 * table - 1.0).T


def rm_decode(soft: torch.Tensor) -> torch.Tensor:
    """(B, 30) soft bits -> (B, 14) message bits of the codeword of the
    largest correlation (the lower message on a tie)."""
    best = torch.argmax(rm_scores(soft), dim=1)
    return ((best[:, None] >> torch.arange(13, -1, -1, device=soft.device))
            & 1).to(torch.uint8)


# ------------------------------------------------------------ slot grid

def sync_fields(bits: np.ndarray) -> dict:
    """The SYNC PDU's fields the grid needs (clause 21.4.4.2): colour
    code, timeslot, frame and multiframe numbers, MCC, MNC."""
    def take(lo, width):
        return int("".join(str(int(b)) for b in bits[lo:lo + width]), 2)
    return {"cc": take(4, 6), "tn": take(10, 2) + 1, "fn": take(12, 5),
            "mn": take(17, 6), "mcc": take(31, 10), "mnc": take(41, 14)}


def advance(tn: int, fn: int, mn: int, slots: int) -> tuple:
    """(TN 1..4, FN 1..18, MN 1..60) moved on by `slots` slots."""
    k = ((mn - 1) * FRAMES_PER_MF + fn - 1) * SLOTS_PER_FRAME + tn - 1
    k = (k + slots) % (SLOTS_PER_FRAME * FRAMES_PER_MF * MF_PER_HF)
    return (k % SLOTS_PER_FRAME + 1,
            k // SLOTS_PER_FRAME % FRAMES_PER_MF + 1,
            k // (SLOTS_PER_FRAME * FRAMES_PER_MF) + 1)


def acquire(soft: torch.Tensor) -> dict | None:
    """Soft bits (n,) -> the slot grid: `first` (the first whole slot's
    bit), its TN/FN/MN and the cell's extended colour code, or None."""
    hard = (soft > 0).cpu().numpy().astype(np.uint8)
    n = hard.size
    if n < STS.size:
        return None
    win = np.lib.stride_tricks.sliding_window_view(hard, STS.size)
    match = (win == STS).sum(axis=1)
    for pos in np.flatnonzero(match >= STS_MIN):
        start = int(pos) - MID
        if start < 0 or start + SLOT > n:
            continue
        bits, ok = decode_channel(soft[None, start + SB1[0]:start + SB1[1]],
                                  "BSCH", 0)
        if bool(ok[0]):
            f = sync_fields(bits[0].cpu().numpy())
            first = start % SLOT
            tn, fn, mn = advance(f["tn"], f["fn"], f["mn"],
                                 -((start - first) // SLOT))
            return {"first": first, "tn": tn, "fn": fn, "mn": mn,
                    "ecc": extended_colour_code(f["mcc"], f["mnc"],
                                                f["cc"])}
    return None


def decode(soft, traffic_channel: str = "TCH/S",
           metric_dtype=torch.float64) -> list:
    """Soft bits (n,) of a downlink -> one dict per whole slot on the grid
    (none where acquisition fails): `index`, `tn`, `fn`, `mn`, `burst`
    ("SB" or "NDB"), `channel`, `ecc` (the cell's colour code), `aach`
    (14 bits) and `aach_soft` (its 30 soft bits, descrambled), and per
    channel its type-1 bits, CRC verdict and type-5 soft bits: SB `bsch`,
    `bsch_ok`, `bsch_soft`, `schd`, `schd_ok`, `schd_soft`; SCH/F and STCH
    `bits`, `ok`, `soft`; a traffic slot none."""
    soft = torch.as_tensor(soft).to(torch.float64).reshape(-1)
    grid = acquire(soft)
    if grid is None:
        return []
    first, ecc = grid["first"], grid["ecc"]
    n_slots = (soft.shape[0] - first) // SLOT
    if n_slots == 0:
        return []
    slots = soft[first:first + n_slots * SLOT].reshape(n_slots, SLOT)
    hard = (slots > 0).cpu().numpy().astype(np.uint8)
    sts = (hard[:, MID:MID + 38] == STS).sum(1)
    nts1 = (hard[:, MID:MID + 22] == NTS1).sum(1)
    nts2 = (hard[:, MID:MID + 22] == NTS2).sum(1)
    is_sb = sts >= np.maximum(nts1, nts2) + 8
    dev = slots.device
    sb_t = torch.as_tensor(is_sb, device=dev)
    bb = torch.where(sb_t[:, None], slots[:, SB_BB[0]:SB_BB[1]],
                     torch.cat([slots[:, NDB_BB1[0]:NDB_BB1[1]],
                                slots[:, NDB_BB2[0]:NDB_BB2[1]]], dim=1))
    seq = torch.as_tensor(scrambling_bits(ecc, 30), device=dev)
    bb = bb * (1.0 - 2.0 * seq.to(torch.float64))
    aach = rm_decode(bb).cpu().numpy()
    traffic = ~is_sb & (aach[:, 0] == 1) & (aach[:, 1] == 1)
    stolen = traffic & (nts2 > nts1)
    ndb = torch.cat([slots[:, BKN1[0]:BKN1[1]], slots[:, BKN2[0]:BKN2[1]]],
                    dim=1)
    # (the slots, their blocks' soft bits, channel, colour code, the keys
    # of its bits, verdict and soft bits in a slot's dict)
    groups = ((is_sb, slots[:, SB1[0]:SB1[1]], "BSCH", 0,
               ("bsch", "bsch_ok", "bsch_soft")),
              (is_sb, slots[:, BKN2[0]:BKN2[1]], "SCH/HD", ecc,
               ("schd", "schd_ok", "schd_soft")),
              (~is_sb & ~traffic, ndb, "SCH/F", ecc, ("bits", "ok", "soft")),
              (stolen, slots[:, BKN1[0]:BKN1[1]], "STCH", ecc,
               ("bits", "ok", "soft")))
    at = {}
    for pick, blocks, channel, code, keys in groups:
        idx = np.flatnonzero(pick)
        if not idx.size:
            continue
        soft_g = blocks[torch.as_tensor(idx, device=dev)]
        bits, ok = decode_channel(soft_g, channel, code, metric_dtype)
        bits, ok = bits.cpu().numpy(), ok.cpu().numpy()
        for j, i in enumerate(idx.tolist()):
            at.setdefault(i, {}).update(zip(keys, (bits[j], bool(ok[j]),
                                                   soft_g[j:j + 1])))
    out = []
    tn, fn, mn = grid["tn"], grid["fn"], grid["mn"]
    for i in range(n_slots):
        slot = {"index": i, "tn": tn, "fn": fn, "mn": mn, "ecc": ecc,
                "burst": "SB" if is_sb[i] else "NDB", "aach": aach[i],
                "aach_soft": bb[i:i + 1]}
        if is_sb[i]:
            slot["channel"] = "BSCH+SCH/HD"
        elif stolen[i]:
            slot["channel"] = f"STCH+{traffic_channel}"
        elif traffic[i]:
            slot["channel"] = traffic_channel
        else:
            slot["channel"] = "SCH/F"
        slot.update(at.get(i, {}))
        out.append(slot)
        tn, fn, mn = advance(tn, fn, mn, 1)
    return out
