"""TETRA channel coding, ETSI EN 300 392-2 section 8 (port of
`tetraear_tpu.ops.channel_coding`).  The control channels:

    type-1 (MAC bits) -> + CRC-16 -> type-2
      -> + 4 tail bits, RCPC encode, puncture to rate 2/3 -> type-3
      -> block interleave -> type-4 -> scramble -> type-5 (on air)

The decode runs the inverse on soft bits, batched on the tensor's device:
descramble (sign flip), de-interleave, depuncture to zeros, Viterbi, CRC.

    BSCH 60 / 120;  SCH/HU 92 / 168;  SCH/HD, BNCH, STCH 124 / 216;
    SCH/F 268 / 432 (type-1 bits / air bits)

The traffic channels (`TCH_GEOMETRY`, `encode_tch`, `decode_tch_soft`)
carry no CRC; TCH/4.8 and TCH/2.4 spread each coded block over 1, 4 or 8
bursts.  The TCH/S speech coding mirror (`tch_s_*`) is host numpy, a
copy of the reference's mirror of native/codec/tetra_channel.c.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from tetraear_tpu_torch.ops import interleave as il
from tetraear_tpu_torch.ops import scramble as scr
from tetraear_tpu_torch.ops import viterbi as vit
from tetraear_tpu_torch.ops.crc import crc16_batch, crc16_bits_arr, crc_tables

CHANNEL_GEOMETRY = {
    # name: (type1_bits, air_bits)
    "BSCH": (60, 120),
    "SCH/HU": (92, 168),
    "SCH/HD": (124, 216),
    "BNCH": (124, 216),
    "STCH": (124, 216),
    "SCH/F": (268, 432),
}


class ChannelDecodeResult(NamedTuple):
    bits: torch.Tensor      # (..., type1) uint8 decoded MAC bits
    crc_ok: torch.Tensor    # (...,) bool


def encode_channel(type1_bits: np.ndarray, channel: str = "SCH/F",
                   ecc30: int = 0) -> np.ndarray:
    """Host full encode (transmitter, test vectors): type-1 -> type-5."""
    k1, air = CHANNEL_GEOMETRY[channel]
    bits = np.asarray(type1_bits).astype(np.uint8) & 1
    assert bits.shape[-1] == k1, (bits.shape, k1)
    type2 = np.concatenate([bits, crc16_bits_arr(bits)])
    type3 = vit.encode_rate_2_3(type2)
    assert type3.shape[-1] == air, (type3.shape, air)
    k, a = il.BLOCK_PARAMS[channel]
    type4 = type3[il._perm(k, a)]
    return (type4 ^ scr.scrambling_sequence(ecc30, air)).astype(np.uint8)


def decode_channel_soft(llrs: torch.Tensor, channel: str = "SCH/F",
                        ecc30: int = 0) -> ChannelDecodeResult:
    """Full decode from soft bits (> 0 meaning bit 1): (..., air_bits)
    f32 -> type-1 bits and the CRC verdict, batched."""
    k1, air = CHANNEL_GEOMETRY[channel]
    assert llrs.shape[-1] == air, (llrs.shape, air)
    x = scr.scramble_soft(llrs.to(torch.float32), ecc30)
    x = il.deinterleave(x, channel)
    bits2 = vit.decode_rate_2_3(x, k1 + 16 + 4)          # data + CRC
    data = bits2[..., :k1]
    calc = crc16_batch(data, *crc_tables(k1, llrs.device))
    ok = torch.all(calc == bits2[..., k1:k1 + 16], dim=-1)
    return ChannelDecodeResult(data.to(torch.uint8), ok)


def decode_channel_hard(bits: torch.Tensor, channel: str = "SCH/F",
                        ecc30: int = 0) -> ChannelDecodeResult:
    """Hard bits {0, 1} as soft values +-1."""
    return decode_channel_soft(bits.to(torch.float32) * 2.0 - 1.0, channel,
                               ecc30)


# ---------------------------------------------------------------------------
# Traffic channels (section 8, table 8.1).  No CRC.  TCH/S carries the
# vocoder's own 432 coded bits (the ACELP channel coder does the FEC), so
# outside the codec its air chain is block interleave + scramble only.
#
#     TCH/7.2   432 type-1 -> 432   (no FEC; scramble only)
#     TCH/4.8   288 type-1 -> +4 tail, RCPC 292->432, N-burst interleave
#     TCH/2.4   144 type-1 -> +4 tail, RCPC 148->432, N-burst interleave
#     TCH/S     432 type-3 (vocoder) -> block interleave + scramble
# ---------------------------------------------------------------------------

TCH_GEOMETRY = {
    # name: (type1_bits, air_bits_per_burst_block)
    "TCH/7.2": (432, 432),
    "TCH/4.8": (288, 432),
    "TCH/2.4": (144, 432),
    "TCH/S": (432, 432),
}


def _scramble_blocks(blocks: np.ndarray, ecc30: int) -> np.ndarray:
    seq = scr.scrambling_sequence(ecc30, blocks.shape[-1])
    return (blocks ^ seq).astype(np.uint8)


def encode_tch(type1_blocks: np.ndarray, channel: str, ecc30: int = 0,
               depth: int = 1) -> np.ndarray:
    """Host traffic encode: (M, k1) -> (M + depth - 1, 432) type-5.
    depth > 1 (TCH/4.8 and TCH/2.4) spreads each coded block diagonally
    over `depth` burst blocks."""
    k1, air = TCH_GEOMETRY[channel]
    blocks = np.atleast_2d(np.asarray(type1_blocks)).astype(np.uint8) & 1
    assert blocks.shape[-1] == k1, (blocks.shape, k1)
    if channel == "TCH/7.2":
        assert depth == 1
        return _scramble_blocks(blocks, ecc30)
    if channel == "TCH/S":
        assert depth == 1
        k, a = il.BLOCK_PARAMS["SCH/F"]
        return _scramble_blocks(blocks[..., il._perm(k, a)], ecc30)
    t3 = np.stack([vit.encode_punctured(b, air) for b in blocks])
    t4 = il.interleave_multiburst(torch.from_numpy(t3), depth,
                                  "SCH/F").numpy()
    return _scramble_blocks(t4, ecc30)


def decode_tch_soft(llr_blocks: torch.Tensor, channel: str, ecc30: int = 0,
                    depth: int = 1) -> torch.Tensor:
    """Traffic decode from per-burst soft bits (> 0 meaning bit 1) on the
    tensor's device: (M + depth - 1, 432) f32 -> (M, k1) uint8 bits, except
    TCH/S, which returns the (M, 432) descrambled, de-interleaved soft
    values for the vocoder's channel decoder
    (audio/blocks.block_from_soft_llrs)."""
    k1, air = TCH_GEOMETRY[channel]
    x = torch.atleast_2d(llr_blocks).to(torch.float32)
    assert x.shape[-1] == air, (x.shape, air)
    x = scr.scramble_soft(x, ecc30)
    if channel == "TCH/7.2":
        assert depth == 1
        return (x > 0).to(torch.uint8)
    if channel == "TCH/S":
        assert depth == 1
        return il.deinterleave(x, "SCH/F")
    t3 = il.deinterleave_multiburst(x, depth, "SCH/F")
    return vit.decode_punctured(t3, k1 + 4)


# ---------------------------------------------------------------------------
# TCH/S speech channel coding: numpy mirror of native/codec/tetra_channel.c
# (EN 300 395-3 structure), as in the reference: cross-validation of the C
# engine and a binary-free path to coded speech blocks.
# ---------------------------------------------------------------------------

TCH_S_BITS_PER_FRAME = 137
_TCH_S_CLASS = (30, 56, 51)             # class 2 / class 1 / class 0
_TCH_S_CRC_BITS = 8
_TCH_S_CONV_IN = 2 * 56 + 2 * 30 + 8 + 4   # 184


def tch_s_sensitivity_order() -> np.ndarray:
    """Bit indices most->least sensitive (mirror of tetra_channel.c)."""
    sfo = (26, 55, 81, 110)
    pb = (8, 5, 8, 5)
    lsfb = (3, 3, 3, 3, 3, 3, 2, 2, 2, 2)
    lsfo = np.cumsum((0,) + lsfb[:-1])
    go = [sfo[s] + pb[s] for s in range(4)]
    order: list[int] = []
    # class 2 (30)
    for s in range(4):
        order += [go[s], go[s] + 3]
    for s in (0, 2):
        order += [sfo[s] + b for b in range(4)]
    order += [int(lsfo[c]) for c in range(6)]
    order += [go[s] + 1 for s in range(4)]
    for s in (1, 3):
        order += [sfo[s] + b for b in range(2)]
    # class 1 (56)
    for s in (0, 2):
        order += [sfo[s] + b for b in range(4, 8)]
    for s in (1, 3):
        order += [sfo[s] + b for b in range(2, 5)]
    for s in range(4):
        order += [go[s] + 2, go[s] + 4, go[s] + 5]
    for c in range(6):
        order += [int(lsfo[c]) + b for b in (1, 2)]
    for c in (6, 7):
        order += [int(lsfo[c]) + b for b in (0, 1)]
    order += [int(lsfo[8]), int(lsfo[9])]
    for s in range(4):
        order += [go[s] + 18 + b for b in range(3)]
    # class 0 (51)
    order += [int(lsfo[8]) + 1, int(lsfo[9]) + 1]
    for s in range(4):
        order += [go[s] + 6 + b for b in range(12)]
    order += [136]
    out = np.asarray(order, np.int64)
    assert out.size == TCH_S_BITS_PER_FRAME
    assert np.unique(out).size == TCH_S_BITS_PER_FRAME
    return out


def _tch_s_crc8(bits: np.ndarray) -> np.ndarray:
    """CRC-8 poly 0x07 init 0xFF over bits MSB-first -> 8 bits."""
    crc = 0xFF
    for b in np.asarray(bits).astype(int) & 1:
        crc ^= b << 7
        crc = ((crc << 1) ^ 0x07 if crc & 0x80 else crc << 1) & 0xFF
    return np.array([(crc >> (7 - i)) & 1 for i in range(8)], np.uint8)


def tch_s_puncture_indices() -> np.ndarray:
    """Kept mother-bit indices for the 330 coded bits: inputs 0..111
    (class 1) at rate 8/12 (keep {0,1,4} of each 8); inputs 112..183
    (class 2 + CRC + tail) at rate 8/18 (keep v1,v2 always + v3 of
    steps 0,4 per 8-step group)."""
    idx = []
    for blk in range(56):                        # 112 inputs / 2
        idx += [blk * 8 + 0, blk * 8 + 1, blk * 8 + 4]
    base = 4 * 112
    for i in range(72):
        idx += [base + 4 * i, base + 4 * i + 1]
        if i % 8 in (0, 4):
            idx.append(base + 4 * i + 2)
    out = np.asarray(idx, np.int64)
    assert out.size == 330
    return out


def tch_s_interleave_positions() -> np.ndarray:
    """transmitted[(103*i) mod 432] = linear[i]."""
    return (103 * np.arange(432, dtype=np.int64)) % 432


def tch_s_encode_block(bits_f1: np.ndarray,
                       bits_f2: np.ndarray) -> np.ndarray:
    """2 x 137 codec bits -> 432 over-the-air coded bits (uint8)."""
    order = tch_s_sensitivity_order()
    f1 = np.asarray(bits_f1, np.uint8) & 1
    f2 = np.asarray(bits_f2, np.uint8) & 1
    cls2 = np.concatenate([f1[order[:30]], f2[order[:30]]])
    cls1 = np.concatenate([f1[order[30:86]], f2[order[30:86]]])
    cls0 = np.concatenate([f1[order[86:]], f2[order[86:]]])
    conv_in = np.concatenate([cls1, cls2, _tch_s_crc8(cls2)])
    mother = vit.conv_encode(conv_in, terminate=True)   # appends 4 tails
    linear = np.concatenate([cls0, mother[tch_s_puncture_indices()]])
    coded = np.zeros(432, np.uint8)
    coded[tch_s_interleave_positions()] = linear
    return coded


def tch_s_decode_block(soft: np.ndarray) -> tuple[np.ndarray, np.ndarray,
                                                  bool]:
    """432 soft bits (>0 <=> 1) -> (bits_f1, bits_f2, bfi).  Same chain
    as cdecoder: de-interleave, de-puncture (0-LLR erasures), soft
    Viterbi over the 392-2 mother code (on the CPU), CRC-8 -> BFI."""
    soft = np.asarray(soft, np.float32)
    linear = soft[tch_s_interleave_positions()]
    llr = np.zeros(4 * _TCH_S_CONV_IN, np.float32)
    llr[tch_s_puncture_indices()] = linear[102:]
    dec = vit.viterbi_decode(torch.from_numpy(llr[None]),
                             _TCH_S_CONV_IN)[0].numpy()
    cls1 = dec[:112]
    cls2 = dec[112:172]
    crc_rx = dec[172:180]
    bfi = not np.array_equal(_tch_s_crc8(cls2), crc_rx)
    order = tch_s_sensitivity_order()
    out = []
    for f in range(2):
        b = np.zeros(TCH_S_BITS_PER_FRAME, np.uint8)
        b[order[:30]] = cls2[f * 30:(f + 1) * 30]
        b[order[30:86]] = cls1[f * 56:(f + 1) * 56]
        b[order[86:]] = (linear[f * 51:(f + 1) * 51] > 0).astype(np.uint8)
        out.append(b)
    return out[0], out[1], bfi
