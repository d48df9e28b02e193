"""Protocol dataclasses and enums (behavioral parity with
tetraear/core/protocol.py:34-139)."""

from __future__ import annotations

from dataclasses import dataclass
from enum import Enum
from typing import List, Optional

import numpy as np


class BurstType(Enum):
    NormalUplink = 1
    NormalDownlink = 2
    ControlUplink = 3
    ControlDownlink = 4
    Synchronization = 5
    Linearization = 6


class ChannelType(Enum):
    TCH = "Traffic Channel"
    STCH = "Stealing Channel"
    SCH = "Signaling Channel"
    AACH = "Associated Control Channel"
    BSCH = "Broadcast Synchronization Channel"
    BNCH = "Broadcast Network Channel"


class PDUType(Enum):
    MAC_RESOURCE = 0
    MAC_FRAG = 1
    MAC_END = 2
    MAC_BROADCAST = 3
    MAC_SUPPL = 4
    MAC_U_SIGNAL = 5
    MAC_DATA = 6
    MAC_U_BLK = 7


@dataclass
class TetraBurst:
    burst_type: BurstType
    slot_number: int
    frame_number: int
    training_sequence: np.ndarray
    data_bits: np.ndarray
    crc_ok: bool
    scrambling_code: int = 0
    colour_code: int = 0


@dataclass
class TetraSlot:
    slot_number: int
    frame_number: int
    burst: TetraBurst
    channel_type: ChannelType
    encrypted: bool = False
    encryption_mode: int = 0


@dataclass
class TetraFrame:
    frame_number: int
    slots: List[TetraSlot]
    multiframe_number: int = 0


@dataclass
class TetraMultiframe:
    multiframe_number: int
    frames: List[TetraFrame]


@dataclass
class TetraHyperframe:
    hyperframe_number: int
    multiframes: List[TetraMultiframe]


@dataclass
class MacPDU:
    pdu_type: PDUType
    encrypted: bool
    address: Optional[int]
    length: int
    data: bytes
    fill_bits: int = 0
    encryption_mode: int = 0       # 0=Clear, 1=Class2, 2=Class3, 3=Reserved
    reassembled_data: Optional[bytes] = None


@dataclass
class CallMetadata:
    call_type: str
    talkgroup_id: Optional[int]
    source_ssi: Optional[int]
    dest_ssi: Optional[int]
    channel_allocated: Optional[int]
    call_identifier: Optional[int] = None
    call_priority: int = 0
    mcc: Optional[int] = None
    mnc: Optional[int] = None
    duplex_mode: str = "simplex"
    encryption_enabled: bool = False
    encryption_algorithm: Optional[str] = None
