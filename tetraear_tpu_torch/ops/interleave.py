"""TETRA block interleaving, ETSI EN 300 392-2 section 8.2.4 (port of
`tetraear_tpu.ops.interleave`).

Over K bits the interleaved position (a k) mod K holds input bit k
(1-indexed in the spec):

    BSCH K=120 a=11;  SCH/HU K=168 a=13;  SCH/HD, BNCH, STCH K=216 a=101;
    SCH/F K=432 a=103.

Interleave and de-interleave are gathers with index vectors made on the
host (numpy, copies of the reference's).  The N-burst diagonal form of
TCH/4.8 and TCH/2.4 (section 8.2.4.2) spreads each block over N
consecutive bursts.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

BLOCK_PARAMS = {
    "BSCH": (120, 11),
    "SCH/HU": (168, 13),
    "SCH/HD": (216, 101),
    "BNCH": (216, 101),
    "STCH": (216, 101),
    "SCH/F": (432, 103),
}


@functools.lru_cache(maxsize=32)
def _perm(k: int, a: int) -> np.ndarray:
    """perm[i] = the input index at interleaved position i."""
    i = (a * (np.arange(k, dtype=np.int64) + 1)) % k
    perm = np.empty(k, dtype=np.int64)
    perm[i] = np.arange(k)
    return perm


@functools.lru_cache(maxsize=32)
def _inv_perm(k: int, a: int) -> np.ndarray:
    perm = _perm(k, a)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(k)
    return inv


def _gather(bits: torch.Tensor, idx: np.ndarray) -> torch.Tensor:
    return bits[..., torch.as_tensor(idx, device=bits.device)]


def interleave(bits: torch.Tensor, channel: str = "SCH/F") -> torch.Tensor:
    k, a = BLOCK_PARAMS[channel]
    assert bits.shape[-1] == k, (bits.shape, k)
    return _gather(bits, _perm(k, a))


def deinterleave(bits: torch.Tensor, channel: str = "SCH/F") -> torch.Tensor:
    k, a = BLOCK_PARAMS[channel]
    assert bits.shape[-1] == k, (bits.shape, k)
    return _gather(bits, _inv_perm(k, a))


def _diagonal(k: int, a: int, depth: int) -> tuple:
    """Type-3 bit i of block B lands in type-4 block B + (i mod depth) at
    position (a (i + 1)) mod K."""
    i = np.arange(k)
    return i, (a * (i + 1)) % k, i % depth


def interleave_multiburst(blocks: torch.Tensor, depth: int,
                          channel: str = "SCH/F") -> torch.Tensor:
    """(M, K) type-3 blocks -> (M + depth - 1, K) type-4 burst blocks; the
    edge blocks are filled only in part (zeros elsewhere)."""
    k, a = BLOCK_PARAMS[channel]
    assert blocks.shape[-1] == k
    m = blocks.shape[0]
    i, pos, off = _diagonal(k, a, depth)
    dev = blocks.device
    rows = (torch.arange(m, device=dev)[:, None]
            + torch.as_tensor(off, device=dev)[None, :])
    out = torch.zeros((m + depth - 1, k), dtype=blocks.dtype, device=dev)
    out[rows, torch.as_tensor(pos, device=dev)[None, :].expand(m, k)] = \
        blocks[:, torch.as_tensor(i, device=dev)]
    return out


def deinterleave_multiburst(bursts: torch.Tensor, depth: int,
                            channel: str = "SCH/F") -> torch.Tensor:
    """(M + depth - 1, K) burst blocks -> (M, K) type-3 blocks, hard bits
    or soft values alike."""
    k, a = BLOCK_PARAMS[channel]
    m = bursts.shape[0] - depth + 1
    assert m >= 1, "need at least `depth` burst blocks"
    i, pos, off = _diagonal(k, a, depth)
    dev = bursts.device
    rows = (torch.arange(m, device=dev)[:, None]
            + torch.as_tensor(off, device=dev)[None, :])
    out = torch.zeros((m, k), dtype=bursts.dtype, device=dev)
    out[:, torch.as_tensor(i, device=dev)] = \
        bursts[rows, torch.as_tensor(pos, device=dev)[None, :].expand(m, k)]
    return out
