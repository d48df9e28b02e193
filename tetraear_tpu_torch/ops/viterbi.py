"""TETRA RCPC convolutional coding (port of `tetraear_tpu.ops.viterbi`):
the rate-1/4 K=5 mother code, its puncturing, and a batched 16-state
soft-decision Viterbi decoder.

ETSI EN 300 392-2 section 8.2.3, generator polynomials

    G1 = 1 + D + D^4,  G2 = 1 + D^2 + D^3 + D^4,
    G3 = 1 + D + D^2 + D^3 + D^4,  G4 = 1 + D + D^3 + D^4.

Rate 2/3 (the control channels) keeps mother bits (0, 1, 4) of every 8.
On a CUDA tensor the decoder is one launch of a hand-written kernel
(`ops/kernels/viterbi`, `csrc/viterbi.cu`) over every trellis step and
the traceback of every code block.  On a CPU tensor it is the plain
version, `viterbi_decode_plain`: add-compare-select over (batch, 16)
path metrics, one vectorised step per trellis step (the branch metrics
of all steps come first, in one pass), then the traceback, one step per
trellis step.  The two are equal bit for bit.  Punctured positions enter
as zero soft values.  The encoders are host numpy code, as in the
reference.
"""

from __future__ import annotations

import functools
import time

import numpy as np
import torch

from tetraear_tpu_torch.ops.kernels import viterbi as kernel
from tetraear_tpu_torch.utils.metrics import record, tracing

# tap masks over [u(k), u(k-1), u(k-2), u(k-3), u(k-4)]
_GENS = ((1, 1, 0, 0, 1),
         (1, 0, 1, 1, 1),
         (1, 1, 1, 1, 1),
         (1, 1, 0, 1, 1))
NUM_STATES = 16
RATE_DEN = 4

# rate-2/3 puncturing: of each 8 serialized mother bits keep {0, 1, 4}
PUNCTURE_2_3 = {"period_in": 2, "keep": (0, 1, 4)}


@functools.lru_cache(maxsize=None)
def _tables():
    """(next_state[s, u], out_bits[s, u, 4]); state s = u(k-1) << 3 |
    u(k-2) << 2 | u(k-3) << 1 | u(k-4)."""
    nxt = np.zeros((NUM_STATES, 2), np.int32)
    out = np.zeros((NUM_STATES, 2, RATE_DEN), np.int8)
    for s in range(NUM_STATES):
        hist = [(s >> 3) & 1, (s >> 2) & 1, (s >> 1) & 1, s & 1]
        for u in (0, 1):
            window = [u] + hist
            for g, taps in enumerate(_GENS):
                out[s, u, g] = sum(w & t for w, t in zip(window, taps)) & 1
            nxt[s, u] = (u << 3) | (s >> 1)
    return nxt, out


def conv_encode(bits: np.ndarray, terminate: bool = True) -> np.ndarray:
    """Mother-code encode (host): (N,) -> (4 (N [+ 4]),) serialized v1..v4
    per step; `terminate` appends the 4 zero tail bits."""
    nxt, out = _tables()
    seq = list(np.asarray(bits).astype(int) & 1)
    if terminate:
        seq += [0, 0, 0, 0]
    s = 0
    coded = []
    for u in seq:
        coded.extend(out[s, u])
        s = nxt[s, u]
    return np.asarray(coded, np.uint8)


def puncture_indices(num_input_bits: int) -> np.ndarray:
    """Serialized mother-bit indices kept at rate 2/3 (num_input_bits
    counts the tail bits and is even)."""
    assert num_input_bits % PUNCTURE_2_3["period_in"] == 0
    blocks = num_input_bits // PUNCTURE_2_3["period_in"]
    keep = np.asarray(PUNCTURE_2_3["keep"], np.int64)
    return (np.arange(blocks)[:, None] * 8 + keep[None, :]).reshape(-1)


def puncture(mother_bits: np.ndarray, num_input_bits: int) -> np.ndarray:
    return np.asarray(mother_bits)[puncture_indices(num_input_bits)]


def _scatter(llrs: torch.Tensor, idx: np.ndarray,
             num_input_bits: int) -> torch.Tensor:
    full = torch.zeros(llrs.shape[:-1] + (RATE_DEN * num_input_bits,),
                       dtype=llrs.dtype, device=llrs.device)
    full[..., torch.as_tensor(idx, device=llrs.device)] = llrs
    return full


def depuncture_llrs(llrs: torch.Tensor, num_input_bits: int) -> torch.Tensor:
    """(..., kept) soft values onto the mother grid, punctured positions
    0: (..., 4 num_input_bits)."""
    return _scatter(llrs, puncture_indices(num_input_bits), num_input_bits)


@functools.lru_cache(maxsize=None)
def _trellis() -> tuple:
    """Per new state s': its two predecessors (s' & 7) << 1 | {0, 1}, the
    input bit s' >> 3 that led there, and the +-1 output signs (16, 2, 4)."""
    _, out = _tables()
    sp = np.arange(NUM_STATES)
    return ((sp & 7) << 1, ((sp & 7) << 1) | 1, sp >> 3,
            out.astype(np.float32) * 2.0 - 1.0)


def viterbi_decode(llrs: torch.Tensor, num_input_bits: int,
                   terminated: bool = True) -> torch.Tensor:
    """Batched soft-decision Viterbi over the mother grid.

    llrs: (..., 4 num_input_bits) f32, > 0 meaning bit 1.  Returns
    (..., num_input_bits - 4) uint8 message bits when `terminated` (the
    path ends in state 0, tail stripped), else all num_input_bits (the
    path ends in the best state, the first on ties).  A tie between a
    state's two predecessors takes predecessor 0.

    A CUDA tensor is decoded by one launch of the kernel, its blocks
    first made contiguous float32 rows (the kernel's wrapper raises on
    anything else, and on N past its MAX_STEPS, 341, which holds every
    code the port decodes); a tensor elsewhere by `viterbi_decode_plain`.

    Under a profiler session (utils.metrics) each call is one inner span
    `viterbi`, the host time of its launches (counters `viterbi.steps`,
    the trellis steps run, `viterbi.blocks`, the code blocks, and
    `viterbi.kernel`, the code blocks the kernel decoded).  It lies
    inside whatever inner span its caller keeps: in the downlink,
    `dl.acquire` and `dl.channel` overlap it."""
    traced = tracing()
    t0 = time.perf_counter_ns() if traced else 0
    rows = llrs.reshape(-1, RATE_DEN * num_input_bits)
    if llrs.device.type == "cuda":
        bits = kernel.viterbi(rows.to(torch.float32).contiguous(),
                              num_input_bits, terminated)
        decoded = bits.shape[0]
    else:
        bits = viterbi_decode_plain(rows, num_input_bits, terminated)
        decoded = 0
    if traced:
        record("viterbi", time.perf_counter_ns() - t0, 1,
               {"viterbi.steps": num_input_bits,
                "viterbi.blocks": bits.shape[0], "viterbi.kernel": decoded})
    return bits.reshape(llrs.shape[:-1] + (bits.shape[-1],))


def viterbi_decode_plain(llrs: torch.Tensor, num_input_bits: int,
                         terminated: bool = True) -> torch.Tensor:
    """The plain version of `viterbi_decode`, with its contract, in
    PyTorch on the tensor's device: the trellis steps one after another,
    about 15 launches each on a card."""
    pred0, pred1, u_new, sign = _trellis()
    dev = llrs.device
    n = num_input_bits
    x = llrs.reshape(-1, n, RATE_DEN).to(torch.float32)        # (B, N, 4)
    bsz = x.shape[0]
    sg = torch.as_tensor(sign, device=dev)                     # (16, 2, 4)
    # branch metric sum_j llr_j sign[s, u, j], summed in j order, for the
    # two branches into each new state s': (B, N, 16)
    bm = []
    for pred in (pred0, pred1):
        s = sg[torch.as_tensor(pred), torch.as_tensor(u_new)]  # (16, 4)
        acc = x[..., 0:1] * s[:, 0]
        for j in range(1, RATE_DEN):
            acc = acc + x[..., j:j + 1] * s[:, j]
        bm.append(acc)
    p0 = torch.as_tensor(pred0, device=dev)
    p1 = torch.as_tensor(pred1, device=dev)
    metrics = torch.full((bsz, NUM_STATES), -1e9, dtype=torch.float32,
                         device=dev)
    metrics[:, 0] = 0.0
    decisions = torch.empty((n, bsz, NUM_STATES), dtype=torch.bool,
                            device=dev)
    for t in range(n):
        m0 = metrics[:, p0] + bm[0][:, t]
        m1 = metrics[:, p1] + bm[1][:, t]
        take1 = m1 > m0
        metrics = torch.where(take1, m1, m0)
        decisions[t] = take1
    state = (torch.zeros(bsz, dtype=torch.int64, device=dev) if terminated
             else torch.argmax(metrics, dim=-1))
    bits = torch.empty((n, bsz), dtype=torch.uint8, device=dev)
    for t in range(n - 1, -1, -1):
        d = decisions[t].gather(1, state[:, None])[:, 0].to(torch.int64)
        bits[t] = (state >> 3).to(torch.uint8)
        state = ((state & 7) << 1) | d
    bits = bits.t()
    if terminated:
        bits = bits[:, :n - 4]
    return bits.reshape(llrs.shape[:-1] + (bits.shape[-1],))


# ---------------------------------------------------------------------------
# EN 300 392-2 section 8.2.3.1.3 puncturing: kept mother bit j (1-based) is
# k(j) = 8 floor((i-1)/t) + P(i - t floor((i-1)/t)), with
#     rate 2/3:            t=3, P=(1,2,5),        i = j
#     rate 1/3:            t=6, P=(1,2,3,5,6,7),  i = j
#     TCH/4.8 (292->432):  t=3, P=(1,2,5),        i = j + (j-1)//65
#     TCH/2.4 (148->432):  t=6, P=(1,2,3,5,6,7),  i = j + (j-1)//35
# ---------------------------------------------------------------------------

_P_2_3 = (0, 1, 4)
_P_1_3 = (0, 1, 2, 4, 5, 6)

_PUNCTURE_SCHEMES = {
    # (num_input_bits incl. tail, num_output_bits): (t, P0, skip period)
    (292, 432): (3, _P_2_3, 65),    # TCH/4.8
    (148, 432): (6, _P_1_3, 35),    # TCH/2.4
}


def puncture_indices_spec(num_input_bits: int,
                          num_output_bits: int) -> np.ndarray:
    """Kept mother-bit indices (0-based) of the section 8.2.3.1.3 rates."""
    if (num_input_bits, num_output_bits) in _PUNCTURE_SCHEMES:
        t, P0, skip = _PUNCTURE_SCHEMES[(num_input_bits, num_output_bits)]
        j = np.arange(1, num_output_bits + 1, dtype=np.int64)
        i = j + (j - 1) // skip
    elif num_output_bits * 2 == num_input_bits * 3:
        t, P0 = 3, _P_2_3
        i = np.arange(1, num_output_bits + 1, dtype=np.int64)
    elif num_output_bits == num_input_bits * 3:
        t, P0 = 6, _P_1_3
        i = np.arange(1, num_output_bits + 1, dtype=np.int64)
    else:
        raise ValueError(
            f"no §8.2.3.1.3 scheme for {num_input_bits}->{num_output_bits}")
    idx = 8 * ((i - 1) // t) + np.asarray(P0, np.int64)[(i - 1) % t]
    assert np.all(np.diff(idx) > 0) and idx[-1] < RATE_DEN * num_input_bits
    return idx


def encode_punctured(bits: np.ndarray, num_output_bits: int) -> np.ndarray:
    """Host tail-terminated encode at a section 8.2.3.1.3 punctured rate."""
    bits = np.asarray(bits)
    mother = conv_encode(bits, terminate=True)
    return mother[puncture_indices_spec(len(bits) + 4, num_output_bits)]


def decode_punctured(llrs: torch.Tensor, num_input_bits: int) -> torch.Tensor:
    """Depuncture (zero soft values) + Viterbi at the punctured rates:
    (..., num_output_bits) -> (..., num_input_bits - 4)."""
    idx = puncture_indices_spec(num_input_bits, llrs.shape[-1])
    return viterbi_decode(_scatter(llrs, idx, num_input_bits),
                          num_input_bits, terminated=True)


def decode_rate_2_3(llrs: torch.Tensor, num_input_bits: int) -> torch.Tensor:
    """Depuncture + Viterbi for the rate-2/3 control channels:
    (..., 3 num_input_bits / 2) -> (..., num_input_bits - 4)."""
    return viterbi_decode(depuncture_llrs(llrs, num_input_bits),
                          num_input_bits, terminated=True)


def encode_rate_2_3(bits: np.ndarray) -> np.ndarray:
    """Host encoder, tail-terminated and punctured: (N,) -> (3 (N+4) / 2,)."""
    bits = np.asarray(bits)
    return puncture(conv_encode(bits, terminate=True), len(bits) + 4)
