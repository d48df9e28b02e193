"""CMCE layer-3 PDUs (EN 300 392-2 §14): circuit-mode call control and
short-data service signalling, routed from the MAC TM-SDU via MLE PD=2.

Implements the downlink call-control set (D-SETUP, D-CONNECT(+ACK),
D-DISCONNECT, D-RELEASE, D-TX-GRANTED/CEASED/CONTINUE/WAIT, D-INFO,
D-CALL-RESTORE, D-STATUS, D-SDS-DATA) plus the uplink PDUs the isolated
uplink monitor can see (U-SETUP, U-STATUS, U-SDS-DATA), with the
standard TETRA PDU encoding: type-1 mandatory fields, O-bit, P-bit
type-2 optionals, M-bit type-3/4 TLV elements (identifier 4, length
indicator 11).

Why this exists: the reference implementation has no CMCE at all — it
guesses call metadata from byte patterns
(tetraear/core/protocol.py:597-784) and sniffs SDS text
by scanning payload bytes for protocol-ID lookalikes (:802-1018).  The
etsi profile decodes the real signalling instead; core/calls.py turns
these PDUs into call-state events compatible with the reference's
CallMetadata schema.

PDU type values and field maps follow §14.7.1/§14.8 (values
cross-checked against public TETRA implementations; exact spec text is
unavailable in this zero-egress environment).  Widths are documented
inline; TX/RX consistency is pinned by round-trip tests
(tests/unit/test_layer3.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from tetraear_tpu_torch.protocol.bits import BitCursor, as_bit_array, pack_fields

__all__ = [
    "DownlinkType", "UplinkType", "Address", "parse_cmce",
    "DSetup", "DConnect", "DConnectAck", "DDisconnect", "DRelease",
    "DTxGranted", "DTxCeased", "DTxContinue", "DTxWait", "DInfo",
    "DCallRestore", "DStatus", "DSdsData",
    "USetup", "UStatus", "USdsData", "GenericCmce",
]


class DownlinkType:
    """5-bit downlink CMCE PDU types (§14.8.28)."""
    D_ALERT = 0
    D_CALL_PROCEEDING = 1
    D_CONNECT = 2
    D_CONNECT_ACK = 3
    D_DISCONNECT = 4
    D_INFO = 5
    D_RELEASE = 6
    D_SETUP = 7
    D_STATUS = 8
    D_TX_CEASED = 9
    D_TX_CONTINUE = 10
    D_TX_GRANTED = 11
    D_TX_WAIT = 12
    D_TX_INTERRUPT = 13
    D_CALL_RESTORE = 14
    D_SDS_DATA = 15
    D_FACILITY = 16


class UplinkType:
    """5-bit uplink CMCE PDU types."""
    U_ALERT = 0
    U_CONNECT = 2
    U_DISCONNECT = 4
    U_INFO = 5
    U_RELEASE = 6
    U_SETUP = 7
    U_STATUS = 8
    U_TX_CEASED = 9
    U_TX_DEMAND = 10
    U_CALL_RESTORE = 14
    U_SDS_DATA = 15


# --------------------------------------------------------------------------
# Composite sub-elements
# --------------------------------------------------------------------------

@dataclass
class Address:
    """Calling/called/transmitting party address: type identifier (2) +
    SNA(8) | SSI(24) | SSI+extension(24+24) (§14.8.x address elements)."""
    kind: int = 1                 # 0=SNA, 1=SSI, 2=SSI+ext
    ssi: int = 0                  # SNA value when kind==0
    extension: int = 0            # MCC/MNC extension when kind==2

    def build(self) -> np.ndarray:
        pairs = [(self.kind, 2)]
        if self.kind == 0:
            pairs.append((self.ssi, 8))
        elif self.kind == 1:
            pairs.append((self.ssi, 24))
        elif self.kind == 2:
            pairs += [(self.ssi, 24), (self.extension, 24)]
        else:
            raise ValueError("reserved address type")
        return pack_fields(pairs)

    @classmethod
    def parse(cls, cur: BitCursor) -> "Address":
        kind = cur.take(2)
        if kind == 0:
            return cls(0, cur.take(8))
        if kind == 1:
            return cls(1, cur.take(24))
        if kind == 2:
            ssi = cur.take(24)
            return cls(2, ssi, cur.take(24))
        raise ValueError("reserved address type")


# type-2 element spec: int width, or (build, parse) for composites
_Type2Spec = object


def _build_optional(pdu, type2: List[Tuple[str, _Type2Spec]],
                    type3: List[Tuple[int, np.ndarray]]) -> np.ndarray:
    """O-bit + P-bit type-2 part + M-bit type-3/4 part (§14.7 encoding
    rules: the optional part exists iff any element is present)."""
    vals = [getattr(pdu, name) for name, _ in type2]
    any_t2 = any(v is not None for v in vals)
    if not (any_t2 or type3):
        return pack_fields([(0, 1)])              # O-bit = 0
    parts = [pack_fields([(1, 1)])]               # O-bit = 1
    for (name, spec), v in zip(type2, vals):
        if v is None:
            parts.append(pack_fields([(0, 1)]))
            continue
        parts.append(pack_fields([(1, 1)]))
        if isinstance(spec, int):
            parts.append(pack_fields([(int(v), spec)]))
        else:
            parts.append(v.build())
    for ident, bits in type3:
        bits = as_bit_array(bits)
        parts.append(pack_fields([(1, 1), (ident, 4), (bits.size, 11)]))
        parts.append(bits)
    parts.append(pack_fields([(0, 1)]))           # final M-bit
    return np.concatenate(parts)


def _parse_optional(pdu, cur: BitCursor,
                    type2: List[Tuple[str, _Type2Spec]]) -> None:
    if cur.remaining < 1 or cur.take(1) == 0:     # O-bit
        return
    for name, spec in type2:
        if cur.take(1) == 0:                      # P-bit
            continue
        if isinstance(spec, int):
            setattr(pdu, name, cur.take(spec))
        else:
            setattr(pdu, name, spec.parse(cur))
    while cur.remaining >= 16 and cur.take(1):    # M-bit chain
        ident = cur.take(4)
        length = cur.take(11)
        pdu.type3.append((ident, cur.take_bits(length)))


class _CmceBase:
    """Shared build/parse over TYPE1 ((name, width) mandatory fields,
    in order, after the 5-bit PDU type) and TYPE2 specs."""

    PDU_TYPE: int = -1
    TYPE1: List[Tuple[str, int]] = []
    TYPE2: List[Tuple[str, _Type2Spec]] = []

    def build(self) -> np.ndarray:
        # PDU type, then type-1 fields (int widths or composites)
        parts = [pack_fields([(self.PDU_TYPE, 5)])]
        for name, width in self.TYPE1:
            v = getattr(self, name)
            if isinstance(width, int):
                parts.append(pack_fields([(int(v), width)]))
            else:
                parts.append(v.build())
        parts.append(_build_optional(self, self.TYPE2, self.type3))
        return np.concatenate(parts)

    @classmethod
    def parse(cls, cur: BitCursor):
        pdu = cls()
        for name, width in cls.TYPE1:
            if isinstance(width, int):
                setattr(pdu, name, cur.take(width))
            else:
                setattr(pdu, name, width.parse(cur))
        _parse_optional(pdu, cur, cls.TYPE2)
        return pdu

    @property
    def name(self) -> str:
        return type(self).__name__


class _AddressSpec:
    """TYPE1/TYPE2 spec adapter for the Address composite."""
    @staticmethod
    def parse(cur: BitCursor) -> Address:
        return Address.parse(cur)


_ADDR = _AddressSpec()


# --------------------------------------------------------------------------
# Downlink call control (§14.7.1)
# --------------------------------------------------------------------------

@dataclass
class DSetup(_CmceBase):
    """D-SETUP (§14.7.1.12): incoming-call announcement."""
    call_identifier: int = 0          # 14
    call_timeout: int = 0             # 4
    hook_method: int = 0              # 1
    simplex_duplex: int = 0           # 1 (0=simplex)
    basic_service_info: int = 0       # 8 (circuit mode type etc.)
    transmission_grant: int = 0       # 2
    transmission_request_permission: int = 0  # 1
    call_priority: int = 0            # 4
    notification_indicator: Optional[int] = None      # 6
    temporary_address: Optional[int] = None           # 24
    calling_party: Optional[Address] = None
    type3: List[Tuple[int, np.ndarray]] = field(default_factory=list)

    PDU_TYPE = DownlinkType.D_SETUP
    TYPE1 = [("call_identifier", 14), ("call_timeout", 4),
             ("hook_method", 1), ("simplex_duplex", 1),
             ("basic_service_info", 8), ("transmission_grant", 2),
             ("transmission_request_permission", 1), ("call_priority", 4)]
    TYPE2 = [("notification_indicator", 6), ("temporary_address", 24),
             ("calling_party", _ADDR)]

    @property
    def is_speech(self) -> bool:
        """Basic service information circuit-mode type: high nibble 0 =
        TCH/S speech (§16.10.7 basic service information element)."""
        return (self.basic_service_info >> 4) == 0


@dataclass
class DConnect(_CmceBase):
    """D-CONNECT (§14.7.1.2): through-connect of the call."""
    call_identifier: int = 0
    call_timeout: int = 0
    hook_method: int = 0
    simplex_duplex: int = 0
    transmission_grant: int = 0
    transmission_request_permission: int = 0
    call_ownership: int = 0
    call_priority: Optional[int] = None
    basic_service_info: Optional[int] = None
    temporary_address: Optional[int] = None
    notification_indicator: Optional[int] = None
    type3: List[Tuple[int, np.ndarray]] = field(default_factory=list)

    PDU_TYPE = DownlinkType.D_CONNECT
    TYPE1 = [("call_identifier", 14), ("call_timeout", 4),
             ("hook_method", 1), ("simplex_duplex", 1),
             ("transmission_grant", 2),
             ("transmission_request_permission", 1), ("call_ownership", 1)]
    TYPE2 = [("call_priority", 4), ("basic_service_info", 8),
             ("temporary_address", 24), ("notification_indicator", 6)]


@dataclass
class DConnectAck(_CmceBase):
    call_identifier: int = 0
    call_timeout: int = 0
    transmission_grant: int = 0
    transmission_request_permission: int = 0
    notification_indicator: Optional[int] = None
    type3: List[Tuple[int, np.ndarray]] = field(default_factory=list)

    PDU_TYPE = DownlinkType.D_CONNECT_ACK
    TYPE1 = [("call_identifier", 14), ("call_timeout", 4),
             ("transmission_grant", 2),
             ("transmission_request_permission", 1)]
    TYPE2 = [("notification_indicator", 6)]


@dataclass
class DDisconnect(_CmceBase):
    call_identifier: int = 0
    disconnect_cause: int = 0         # 5 (§14.8.26)
    notification_indicator: Optional[int] = None
    type3: List[Tuple[int, np.ndarray]] = field(default_factory=list)

    PDU_TYPE = DownlinkType.D_DISCONNECT
    TYPE1 = [("call_identifier", 14), ("disconnect_cause", 5)]
    TYPE2 = [("notification_indicator", 6)]


@dataclass
class DRelease(_CmceBase):
    call_identifier: int = 0
    disconnect_cause: int = 0
    notification_indicator: Optional[int] = None
    type3: List[Tuple[int, np.ndarray]] = field(default_factory=list)

    PDU_TYPE = DownlinkType.D_RELEASE
    TYPE1 = [("call_identifier", 14), ("disconnect_cause", 5)]
    TYPE2 = [("notification_indicator", 6)]


@dataclass
class DTxGranted(_CmceBase):
    """D-TX-GRANTED (§14.7.1.15): floor grant — names the transmitting
    party, the key signal for who is talking."""
    call_identifier: int = 0
    transmission_grant: int = 0       # 2 (1 = granted)
    transmission_request_permission: int = 0
    encryption_control: int = 0       # 1
    notification_indicator: Optional[int] = None
    transmitting_party: Optional[Address] = None
    type3: List[Tuple[int, np.ndarray]] = field(default_factory=list)

    PDU_TYPE = DownlinkType.D_TX_GRANTED
    TYPE1 = [("call_identifier", 14), ("transmission_grant", 2),
             ("transmission_request_permission", 1),
             ("encryption_control", 1)]
    TYPE2 = [("notification_indicator", 6), ("transmitting_party", _ADDR)]


@dataclass
class DTxCeased(_CmceBase):
    call_identifier: int = 0
    transmission_request_permission: int = 0
    notification_indicator: Optional[int] = None
    type3: List[Tuple[int, np.ndarray]] = field(default_factory=list)

    PDU_TYPE = DownlinkType.D_TX_CEASED
    TYPE1 = [("call_identifier", 14),
             ("transmission_request_permission", 1)]
    TYPE2 = [("notification_indicator", 6)]


@dataclass
class DTxContinue(_CmceBase):
    call_identifier: int = 0
    continue_flag: int = 0            # 1
    transmission_request_permission: int = 0
    notification_indicator: Optional[int] = None
    type3: List[Tuple[int, np.ndarray]] = field(default_factory=list)

    PDU_TYPE = DownlinkType.D_TX_CONTINUE
    TYPE1 = [("call_identifier", 14), ("continue_flag", 1),
             ("transmission_request_permission", 1)]
    TYPE2 = [("notification_indicator", 6)]


@dataclass
class DTxWait(_CmceBase):
    call_identifier: int = 0
    transmission_request_permission: int = 0
    notification_indicator: Optional[int] = None
    type3: List[Tuple[int, np.ndarray]] = field(default_factory=list)

    PDU_TYPE = DownlinkType.D_TX_WAIT
    TYPE1 = [("call_identifier", 14),
             ("transmission_request_permission", 1)]
    TYPE2 = [("notification_indicator", 6)]


@dataclass
class DInfo(_CmceBase):
    call_identifier: int = 0
    reset_call_timeout: int = 0       # 4
    poll_request: int = 0             # 1
    new_call_identifier: Optional[int] = None   # 14
    notification_indicator: Optional[int] = None
    type3: List[Tuple[int, np.ndarray]] = field(default_factory=list)

    PDU_TYPE = DownlinkType.D_INFO
    TYPE1 = [("call_identifier", 14), ("reset_call_timeout", 4),
             ("poll_request", 1)]
    TYPE2 = [("new_call_identifier", 14), ("notification_indicator", 6)]


@dataclass
class DCallRestore(_CmceBase):
    call_identifier: int = 0
    transmission_grant: int = 0
    transmission_request_permission: int = 0
    reset_call_timeout: int = 0
    notification_indicator: Optional[int] = None
    type3: List[Tuple[int, np.ndarray]] = field(default_factory=list)

    PDU_TYPE = DownlinkType.D_CALL_RESTORE
    TYPE1 = [("call_identifier", 14), ("transmission_grant", 2),
             ("transmission_request_permission", 1),
             ("reset_call_timeout", 4)]
    TYPE2 = [("notification_indicator", 6)]


@dataclass
class DStatus(_CmceBase):
    """D-STATUS (§14.7.1.13): pre-coded status from another party."""
    calling_party: Address = field(default_factory=Address)
    precoded_status: int = 0          # 16
    notification_indicator: Optional[int] = None
    type3: List[Tuple[int, np.ndarray]] = field(default_factory=list)

    PDU_TYPE = DownlinkType.D_STATUS
    TYPE1 = [("calling_party", _ADDR), ("precoded_status", 16)]
    TYPE2 = [("notification_indicator", 6)]


@dataclass
class DSdsData(_CmceBase):
    """D-SDS-DATA (§14.7.1.11): short data to the MS.  The user data is
    selected by the 2-bit short-data type identifier: 0/1/2 = fixed
    16/32/64-bit user-defined data, 3 = length indicator (11) + bits
    (SDS type 4 — where SDS-TL lives, protocol/sds_tl.py)."""
    calling_party: Address = field(default_factory=Address)
    short_data_type: int = 3          # 2
    user_data: int = 0                # sdti 0..2: the fixed-width value
    data_bits: np.ndarray = field(
        default_factory=lambda: np.zeros(0, np.uint8))  # sdti 3
    notification_indicator: Optional[int] = None
    type3: List[Tuple[int, np.ndarray]] = field(default_factory=list)

    PDU_TYPE = DownlinkType.D_SDS_DATA
    TYPE1 = [("calling_party", _ADDR)]
    TYPE2 = [("notification_indicator", 6)]
    _FIXED = {0: 16, 1: 32, 2: 64}

    def build(self) -> np.ndarray:
        parts = [pack_fields([(self.PDU_TYPE, 5)]),
                 self.calling_party.build(),
                 pack_fields([(self.short_data_type, 2)])]
        if self.short_data_type in self._FIXED:
            parts.append(pack_fields(
                [(self.user_data, self._FIXED[self.short_data_type])]))
        else:
            bits = as_bit_array(self.data_bits)
            if bits.size > 2047:
                raise ValueError("SDS type-4 data exceeds 2047 bits")
            parts.append(pack_fields([(bits.size, 11)]))
            parts.append(bits)
        parts.append(_build_optional(self, self.TYPE2, self.type3))
        return np.concatenate(parts)

    @classmethod
    def parse(cls, cur: BitCursor) -> "DSdsData":
        pdu = cls(calling_party=Address.parse(cur))
        pdu.short_data_type = cur.take(2)
        if pdu.short_data_type in cls._FIXED:
            pdu.user_data = cur.take(cls._FIXED[pdu.short_data_type])
        else:
            length = cur.take(11)
            pdu.data_bits = cur.take_bits(length)
        _parse_optional(pdu, cur, cls.TYPE2)
        return pdu


# --------------------------------------------------------------------------
# Uplink PDUs the isolated-burst monitor can decode
# --------------------------------------------------------------------------

@dataclass
class USetup(_CmceBase):
    area_selection: int = 0           # 4
    hook_method: int = 0
    simplex_duplex: int = 0
    basic_service_info: int = 0
    request_transmission: int = 0     # 1
    call_priority: int = 0
    called_party: Address = field(default_factory=Address)
    notification_indicator: Optional[int] = None
    type3: List[Tuple[int, np.ndarray]] = field(default_factory=list)

    PDU_TYPE = UplinkType.U_SETUP
    TYPE1 = [("area_selection", 4), ("hook_method", 1),
             ("simplex_duplex", 1), ("basic_service_info", 8),
             ("request_transmission", 1), ("call_priority", 4),
             ("called_party", _ADDR)]
    TYPE2 = [("notification_indicator", 6)]


@dataclass
class UStatus(_CmceBase):
    area_selection: int = 0
    called_party: Address = field(default_factory=Address)
    precoded_status: int = 0
    notification_indicator: Optional[int] = None
    type3: List[Tuple[int, np.ndarray]] = field(default_factory=list)

    PDU_TYPE = UplinkType.U_STATUS
    TYPE1 = [("area_selection", 4), ("called_party", _ADDR),
             ("precoded_status", 16)]
    TYPE2 = [("notification_indicator", 6)]


@dataclass
class USdsData(_CmceBase):
    area_selection: int = 0
    called_party: Address = field(default_factory=Address)
    short_data_type: int = 3
    user_data: int = 0
    data_bits: np.ndarray = field(
        default_factory=lambda: np.zeros(0, np.uint8))
    notification_indicator: Optional[int] = None
    type3: List[Tuple[int, np.ndarray]] = field(default_factory=list)

    PDU_TYPE = UplinkType.U_SDS_DATA
    TYPE1 = [("area_selection", 4), ("called_party", _ADDR)]
    TYPE2 = [("notification_indicator", 6)]
    _FIXED = DSdsData._FIXED

    def build(self) -> np.ndarray:
        parts = [pack_fields([(self.PDU_TYPE, 5),
                              (self.area_selection, 4)]),
                 self.called_party.build(),
                 pack_fields([(self.short_data_type, 2)])]
        if self.short_data_type in self._FIXED:
            parts.append(pack_fields(
                [(self.user_data, self._FIXED[self.short_data_type])]))
        else:
            bits = as_bit_array(self.data_bits)
            if bits.size > 2047:
                raise ValueError("SDS type-4 data exceeds 2047 bits")
            parts.append(pack_fields([(bits.size, 11)]))
            parts.append(bits)
        parts.append(_build_optional(self, self.TYPE2, self.type3))
        return np.concatenate(parts)

    @classmethod
    def parse(cls, cur: BitCursor) -> "USdsData":
        pdu = cls(area_selection=cur.take(4),
                  called_party=Address.parse(cur))
        pdu.short_data_type = cur.take(2)
        if pdu.short_data_type in cls._FIXED:
            pdu.user_data = cur.take(cls._FIXED[pdu.short_data_type])
        else:
            length = cur.take(11)
            pdu.data_bits = cur.take_bits(length)
        _parse_optional(pdu, cur, cls.TYPE2)
        return pdu


@dataclass
class GenericCmce:
    """Recognized CMCE type without a field map yet: opaque body."""
    pdu_type: int = 0
    body: np.ndarray = field(default_factory=lambda: np.zeros(0, np.uint8))

    @property
    def name(self) -> str:
        return f"CMCE-{self.pdu_type}"


_DOWNLINK_REGISTRY = {
    cls.PDU_TYPE: cls for cls in (
        DConnect, DConnectAck, DDisconnect, DInfo, DRelease, DSetup,
        DStatus, DTxCeased, DTxContinue, DTxGranted, DTxWait,
        DCallRestore, DSdsData)
}

_UPLINK_REGISTRY = {cls.PDU_TYPE: cls for cls in (USetup, UStatus,
                                                  USdsData)}


def parse_cmce(bits, uplink: bool = False):
    """Entity-PDU bits (after the MLE discriminator) -> typed CMCE PDU.

    Unknown-but-plausible types come back as ``GenericCmce``; malformed
    content (bit underrun, reserved address type) raises ``ValueError``
    so layer3.py can reject the block.
    """
    cur = BitCursor(bits)
    pdu_type = cur.take(5)
    registry = _UPLINK_REGISTRY if uplink else _DOWNLINK_REGISTRY
    cls = registry.get(pdu_type)
    if cls is None:
        return GenericCmce(pdu_type, cur.take_bits(cur.remaining))
    return cls.parse(cur)
