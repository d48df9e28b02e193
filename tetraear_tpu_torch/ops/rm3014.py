"""AACH block code: the shortened (30, 14) Reed-Muller code with a
maximum-likelihood matmul decoder, ETSI EN 300 392-2 section 8.2.3.2
(port of `tetraear_tpu.ops.rm3014`).

The (30, 14) code shortens the second-order Reed-Muller code RM(2, 5) =
(32, 16, 8): two information positions fixed to zero and their
coordinates deleted, minimum distance 8.  The generator and the table of
all 2^14 codewords are host numpy, copies of the reference's.

`decode_soft` is exact soft-decision maximum likelihood: the (B, 30)
soft bits times the (30, 16384) table of codeword signs, one
`torch.matmul` on the tensor's device in full f32 (TF32 off on the card),
then the top two scores.  It is a plain product, outside any kernel, as
in the reference.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

N_BITS = 30      # codeword length
K_BITS = 14      # message length
D_MIN = 8        # minimum distance (pinned by tests)


@functools.lru_cache(maxsize=1)
def generator_matrix() -> np.ndarray:
    """Systematic (14, 30) generator over F2.

    Built from RM(2,5): rows = [1, v1..v5, v_i v_j (i<j)] on the 32 points
    of F_2^5, reduced to systematic form on the first 16 coordinates, then
    shortened by dropping the last two information rows and their pivot
    columns.
    """
    pts = np.arange(32, dtype=np.uint8)
    v = np.stack([(pts >> i) & 1 for i in range(5)])            # (5, 32)
    rows = [np.ones(32, dtype=np.uint8)]
    rows.extend(v)
    for i in range(5):
        for j in range(i + 1, 5):
            rows.append(v[i] & v[j])
    g = np.stack(rows)                                          # (16, 32)

    # Gauss-Jordan to systematic form (pivots on the first 16 columns).
    g = g.copy()
    pivots = []
    r = 0
    for c in range(32):
        if r >= 16:
            break
        hit = np.flatnonzero(g[r:, c]) + r
        if hit.size == 0:
            continue
        if hit[0] != r:
            g[[r, hit[0]]] = g[[hit[0], r]]
        for rr in range(16):
            if rr != r and g[rr, c]:
                g[rr] ^= g[r]
        pivots.append(c)
        r += 1
    assert r == 16 and len(pivots) == 16

    # Shorten: drop the last two information rows and their pivot columns.
    drop_cols = sorted(pivots[14:])
    keep_cols = [c for c in range(32) if c not in drop_cols]
    gs = g[:14, keep_cols]                                      # (14, 30)
    assert gs.shape == (K_BITS, N_BITS)
    return gs.astype(np.uint8)


@functools.lru_cache(maxsize=1)
def codeword_table() -> np.ndarray:
    """All 2^14 codewords, (16384, 30) uint8; row index == message value
    with message bit 0 as the MSB (big-endian, matching bits_to_uint)."""
    g = generator_matrix()
    msgs = np.arange(1 << K_BITS, dtype=np.uint32)
    mbits = ((msgs[:, None] >> np.arange(K_BITS - 1, -1, -1)[None, :]) & 1)
    return (mbits.astype(np.uint8) @ g) & 1                     # mod-2


def encode(bits14: np.ndarray) -> np.ndarray:
    """Host encode: (..., 14) message bits -> (..., 30) codeword bits."""
    b = np.asarray(bits14).astype(np.uint8) & 1
    assert b.shape[-1] == K_BITS, b.shape
    return (b @ generator_matrix()) & 1


@functools.lru_cache(maxsize=1)
def _sign_table() -> np.ndarray:
    """(30, 16384) float32 of ±1 codeword signs (+1 where bit == 1)."""
    return np.ascontiguousarray(
        (codeword_table().astype(np.float32) * 2.0 - 1.0).T)


@functools.lru_cache(maxsize=4)
def _device_sign_table(device: torch.device) -> torch.Tensor:
    return torch.as_tensor(_sign_table(), device=device)


def decode_soft(llrs: torch.Tensor):
    """ML decode soft bits (llr > 0 <=> bit 1).

    llrs: (..., 30) float32.
    Returns (bits14 (..., 14) uint8, margin (...,) float32) where margin is
    the winning correlation minus the runner-up (confidence; 0 on ties).
    On a tie the lower message value wins, as in the reference.
    """
    assert llrs.shape[-1] == N_BITS, llrs.shape
    batch_shape = tuple(llrs.shape[:-1])
    x = llrs.reshape(-1, N_BITS).to(torch.float32)
    table = _device_sign_table(x.device)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        scores = x @ table                              # (B, 16384)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    # the first index of the maximum, as the reference's top_k orders ties
    best = torch.argmax(scores, dim=-1)
    top = scores.gather(-1, best[:, None])[:, 0]
    second = scores.scatter(-1, best[:, None], float("-inf")).amax(dim=-1)
    margin = top - second
    shifts = torch.arange(K_BITS - 1, -1, -1, device=x.device)
    bits = ((best[:, None] >> shifts[None, :]) & 1).to(torch.uint8)
    return (bits.reshape(batch_shape + (K_BITS,)),
            margin.reshape(batch_shape))


def decode_hard(bits30: np.ndarray):
    """Hard-decision convenience wrapper (host in, host out).

    Returns (bits14, hamming_distance_to_nearest_codeword).
    """
    b = np.asarray(bits30).astype(np.float32) * 2.0 - 1.0
    bits, margin = decode_soft(torch.from_numpy(b))
    bits = bits.numpy()
    # distance = (30 - correlation)/2 with the winning codeword
    cw = encode(bits)
    dist = int(np.sum(cw != (np.asarray(bits30).astype(np.uint8) & 1)))
    del margin
    return bits, dist
