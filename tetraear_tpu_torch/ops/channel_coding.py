"""TETRA control-channel coding, ETSI EN 300 392-2 section 8 (port of the
control-channel part of `tetraear_tpu.ops.channel_coding`):

    type-1 (MAC bits) -> + CRC-16 -> type-2
      -> + 4 tail bits, RCPC encode, puncture to rate 2/3 -> type-3
      -> block interleave -> type-4 -> scramble -> type-5 (on air)

The decode runs the inverse on soft bits, batched on the tensor's device:
descramble (sign flip), de-interleave, depuncture to zeros, Viterbi, CRC.

    BSCH 60 / 120;  SCH/HU 92 / 168;  SCH/HD, BNCH, STCH 124 / 216;
    SCH/F 268 / 432 (type-1 bits / air bits)
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
