"""The etsi-profile link layer (port of `tetraear_tpu.models.etsi_link`):
transmit-side burst building and sync-driven receive down to MAC bits.

    burst := TS1 (22 bits = 11 symbols) || type-5 coded block
    SCH/F block = 432 bits (216 symbols) -> burst = 227 symbols

Receive: the etsi receiver's dense TS1/TS2 scores locate the bursts (a
greedy walk on the host); the soft bits after each hit go through the
channel decode on the receiver's device, and CRC-valid MAC bits through
the port's copy of the reference's protocol parser.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np
import torch

from tetraear_tpu_torch import constants as C
from tetraear_tpu_torch.config import ReceiverConfig
from tetraear_tpu_torch.models.receiver_etsi import EtsiReceiver
from tetraear_tpu_torch.ops import channel_coding as cc
from tetraear_tpu_torch.protocol.parser import TetraProtocolParser
from tetraear_tpu_torch.utils import synth

SYNC_SYMBOLS = C.SYNC_LEN_BITS // 2          # 11


class EtsiFrame(NamedTuple):
    sync_symbol: int          # symbol index of the TS1 hit
    crc_ok: bool
    mac_bits: np.ndarray      # (type1,) decoded MAC bits
    mac_pdu: Optional[object]


def build_burst_bits(type1_bits: np.ndarray, channel: str = "SCH/F",
                     ecc30: int = 0) -> np.ndarray:
    """MAC bits -> over-the-air burst bits (TS1 || type-5 block)."""
    coded = cc.encode_channel(type1_bits, channel, ecc30=ecc30)
    return np.concatenate([C.TS1, coded]).astype(np.uint8)


def transmit(mac_frames: List[np.ndarray], channel: str = "SCH/F",
             ecc30: int = 0, gap_symbols: int = 16,
             sample_rate: float = C.DEFAULT_SAMPLE_RATE_HZ,
             symbol_rate: float = C.SYMBOL_RATE_HZ,
             snr_db: float | None = None, seed: int = 0) -> np.ndarray:
    """MAC bit blocks -> pi/4-DQPSK IQ at the capture rate (host numpy)."""
    rng = np.random.default_rng(seed)
    pieces = [rng.integers(0, 2, 2 * gap_symbols).astype(np.uint8)]
    for mac in mac_frames:
        pieces.append(build_burst_bits(mac, channel, ecc30))
        pieces.append(rng.integers(0, 2, 2 * gap_symbols).astype(np.uint8))
    bits = np.concatenate(pieces)
    phasors = synth.synthesize_symbol_phasors(synth.bits_to_symbols(bits),
                                              mapping="pi4")
    x = synth.upsample_hold(phasors, sample_rate, symbol_rate)
    if snr_db is not None:
        std = 10 ** (-snr_db / 20) / np.sqrt(2)
        x = x + std * (rng.standard_normal(len(x))
                       + 1j * rng.standard_normal(len(x)))
    return x.astype(np.complex64)


class EtsiLinkReceiver:
    """IQ -> CRC-gated MAC bits -> parsed PDUs (the full etsi RX stack)
    on an explicit device."""

    SYNC_THRESHOLD = 0.86     # 19 of the 22 TS bits must match

    def __init__(self, config: ReceiverConfig | None = None,
                 channel: str = "SCH/F", ecc30: int = 0, *, device):
        self.rx = EtsiReceiver(config, device=device)
        self.channel = channel
        self.ecc30 = ecc30
        self.parser = TetraProtocolParser()
        _, self.air_bits = cc.CHANNEL_GEOMETRY[channel]

    def receive(self, iq, freq_offset: float = 0.0) -> List[EtsiFrame]:
        res = self.rx(iq, freq_offset)
        count = int(res.count)
        if count < SYNC_SYMBOLS + self.air_bits // 2 + 2:
            return []
        soft = res.soft_bits[:count - 1].reshape(-1)
        corr = res.sync_corr[:max(0, 2 * (count - 1)
                                  - C.SYNC_LEN_BITS + 1)].cpu().numpy()

        # greedy sync walk, skipping a burst after each hit
        burst_bits = C.SYNC_LEN_BITS + self.air_bits
        hits = []
        i = 0
        cand = np.flatnonzero(corr >= self.SYNC_THRESHOLD)
        while True:
            ci = np.searchsorted(cand, i)
            if ci >= len(cand):
                break
            pos = int(cand[ci])
            hits.append(pos)
            i = pos + burst_bits - C.SYNC_LEN_BITS // 2

        starts = [pos + C.SYNC_LEN_BITS for pos in hits
                  if pos + C.SYNC_LEN_BITS + self.air_bits <= soft.shape[0]]
        if not starts:
            return []
        # every burst's soft bits decoded in one batch on the device
        idx = (torch.as_tensor(starts, device=soft.device)[:, None]
               + torch.arange(self.air_bits, device=soft.device)[None, :])
        dec = cc.decode_channel_soft(soft[idx], self.channel,
                                     ecc30=self.ecc30)
        crc_ok = dec.crc_ok.cpu().numpy()
        mac_bits = dec.bits.cpu().numpy()
        frames: List[EtsiFrame] = []
        for k, start in enumerate(starts):
            pdu = None
            if crc_ok[k]:
                try:
                    pdu = self.parser.parse_mac_pdu(mac_bits[k])
                except Exception:
                    pdu = None
            frames.append(EtsiFrame((start - C.SYNC_LEN_BITS) // 2,
                                    bool(crc_ok[k]), mac_bits[k], pdu))
        return frames
