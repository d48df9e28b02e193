"""MM (mobility management) layer-3 PDUs (EN 300 392-2 §16), routed via
MLE PD=1: registration outcomes and group attachment — what a monitoring
receiver sees of subscriber mobility on the downlink.

The reference implementation has no MM decoding whatsoever; anything on
these channels falls through its binary-preview path
(tetraear/core/protocol.py:940-1018).

PDU types are 4-bit (§16.10.39, downlink set); field maps per §16.9
with widths documented inline (cross-checked against public TETRA
implementations; spec text unavailable in this zero-egress
environment).  Type-3/4 elements are carried opaquely as (identifier,
bits) pairs — group identity lists etc. can be decoded downstream
without changing this codec.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from tetraear_tpu_torch.protocol.bits import BitCursor, pack_fields
from tetraear_tpu_torch.protocol.cmce import _build_optional, _parse_optional

__all__ = ["DownlinkMmType", "parse_mm", "DLocationUpdateAccept",
           "DLocationUpdateCommand", "DLocationUpdateReject",
           "DLocationUpdateProceeding", "DAttachDetachGroupIdentity",
           "DAttachDetachGroupIdentityAck", "DMmStatus", "GenericMm",
           "GroupIdentity", "GROUP_IDENTITY_DOWNLINK"]


class DownlinkMmType:
    """4-bit downlink MM PDU types (§16.10.39)."""
    D_OTAR = 0
    D_AUTHENTICATION = 1
    D_CK_CHANGE_DEMAND = 2
    D_DISABLE = 3
    D_ENABLE = 4
    D_LOCATION_UPDATE_ACCEPT = 5
    D_LOCATION_UPDATE_COMMAND = 6
    D_LOCATION_UPDATE_REJECT = 7
    D_LOCATION_UPDATE_PROCEEDING = 9
    D_ATTACH_DETACH_GROUP_IDENTITY = 10
    D_ATTACH_DETACH_GROUP_IDENTITY_ACK = 11
    D_MM_STATUS = 12


class _MmBase:
    PDU_TYPE: int = -1
    TYPE1: List[Tuple[str, int]] = []
    TYPE2: List[Tuple[str, object]] = []

    def build(self) -> np.ndarray:
        parts = [pack_fields([(self.PDU_TYPE, 4)])]
        for name, width in self.TYPE1:
            parts.append(pack_fields([(int(getattr(self, name)), width)]))
        parts.append(_build_optional(self, self.TYPE2, self.type3))
        return np.concatenate(parts)

    @classmethod
    def parse(cls, cur: BitCursor):
        pdu = cls()
        for name, width in cls.TYPE1:
            setattr(pdu, name, cur.take(width))
        _parse_optional(pdu, cur, cls.TYPE2)
        return pdu

    @property
    def name(self) -> str:
        return type(self).__name__


@dataclass
class DLocationUpdateAccept(_MmBase):
    """D-LOCATION-UPDATE-ACCEPT (§16.9.2.5): registration granted."""
    location_update_accept_type: int = 0   # 3 (roaming/migrating/ITSI...)
    ssi: Optional[int] = None              # 24
    address_extension: Optional[int] = None  # 24
    subscriber_class: Optional[int] = None   # 16
    energy_saving_information: Optional[int] = None  # 14
    scch_information: Optional[int] = None   # 4
    type3: List[Tuple[int, np.ndarray]] = field(default_factory=list)

    PDU_TYPE = DownlinkMmType.D_LOCATION_UPDATE_ACCEPT
    TYPE1 = [("location_update_accept_type", 3)]
    TYPE2 = [("ssi", 24), ("address_extension", 24),
             ("subscriber_class", 16), ("energy_saving_information", 14),
             ("scch_information", 4)]


@dataclass
class DLocationUpdateCommand(_MmBase):
    """D-LOCATION-UPDATE-COMMAND (§16.9.2.6): SwMI orders re-registration."""
    group_identity_report: int = 0         # 1
    cipher_control: Optional[int] = None   # 1
    type3: List[Tuple[int, np.ndarray]] = field(default_factory=list)

    PDU_TYPE = DownlinkMmType.D_LOCATION_UPDATE_COMMAND
    TYPE1 = [("group_identity_report", 1)]
    TYPE2 = [("cipher_control", 1)]


@dataclass
class DLocationUpdateReject(_MmBase):
    """D-LOCATION-UPDATE-REJECT (§16.9.2.7)."""
    location_update_type: int = 0          # 3
    reject_cause: int = 0                  # 5 (§16.10.42)
    cipher_control: Optional[int] = None
    type3: List[Tuple[int, np.ndarray]] = field(default_factory=list)

    PDU_TYPE = DownlinkMmType.D_LOCATION_UPDATE_REJECT
    TYPE1 = [("location_update_type", 3), ("reject_cause", 5)]
    TYPE2 = [("cipher_control", 1)]


@dataclass
class DLocationUpdateProceeding(_MmBase):
    """D-LOCATION-UPDATE-PROCEEDING (§16.9.2.8): interim response while
    the SwMI resolves the registration."""
    ssi: int = 0                           # 24
    address_extension: Optional[int] = None
    type3: List[Tuple[int, np.ndarray]] = field(default_factory=list)

    PDU_TYPE = DownlinkMmType.D_LOCATION_UPDATE_PROCEEDING
    TYPE1 = [("ssi", 24)]
    TYPE2 = [("address_extension", 24)]


# Type-3/4 element identifier for group identity lists (§16.10.x)
GROUP_IDENTITY_DOWNLINK = 7


@dataclass
class GroupIdentity:
    """One repeated element of the group-identity-downlink type-4
    list (§16.10.10): attach (with lifetime + class of usage) or detach
    (with reason) of one GSSI."""
    gssi: int = 0
    attach: bool = True
    lifetime: int = 0             # 2 (attach only)
    class_of_usage: int = 0       # 3 (attach only)
    detach_reason: int = 0        # 2 (detach only)
    extension: Optional[int] = None  # 24 when address type 1

    def build(self) -> np.ndarray:
        pairs = [(0 if self.attach else 1, 1)]
        if self.attach:
            pairs += [(self.lifetime, 2), (self.class_of_usage, 3)]
        else:
            pairs += [(self.detach_reason, 2)]
        pairs.append((0 if self.extension is None else 1, 2))
        pairs.append((self.gssi, 24))
        if self.extension is not None:
            pairs.append((self.extension, 24))
        return pack_fields(pairs)

    @classmethod
    def parse(cls, cur: BitCursor) -> "GroupIdentity":
        g = cls(attach=cur.take(1) == 0)
        if g.attach:
            g.lifetime = cur.take(2)
            g.class_of_usage = cur.take(3)
        else:
            g.detach_reason = cur.take(2)
        addr_type = cur.take(2)
        g.gssi = cur.take(24)
        if addr_type == 1:
            g.extension = cur.take(24)
        elif addr_type > 1:
            raise ValueError("reserved group identity address type")
        return g


def build_group_identity_list(groups: List[GroupIdentity]) -> np.ndarray:
    return (np.concatenate([g.build() for g in groups])
            if groups else np.zeros(0, np.uint8))


def parse_group_identity_list(bits) -> List[GroupIdentity]:
    cur = BitCursor(bits)
    out: List[GroupIdentity] = []
    while cur.remaining >= 29:            # smallest element: detach+GSSI
        try:
            out.append(GroupIdentity.parse(cur))
        except ValueError:                # trailing junk, stop cleanly
            break
    return out


@dataclass
class DAttachDetachGroupIdentity(_MmBase):
    """D-ATTACH-DETACH-GROUP-IDENTITY (§16.9.2.1): SwMI-initiated group
    membership change; the groups ride in a type-4 element
    (GROUP_IDENTITY_DOWNLINK, decoded by the `groups` property)."""
    group_identity_report: int = 0         # 1
    group_identity_ack_request: int = 0    # 1
    attach_detach_mode: int = 0            # 1 (0=amendment, 1=detach all)
    type3: List[Tuple[int, np.ndarray]] = field(default_factory=list)

    PDU_TYPE = DownlinkMmType.D_ATTACH_DETACH_GROUP_IDENTITY
    TYPE1 = [("group_identity_report", 1),
             ("group_identity_ack_request", 1),
             ("attach_detach_mode", 1)]
    TYPE2 = []

    @property
    def groups(self) -> List[GroupIdentity]:
        for ident, bits in self.type3:
            if ident == GROUP_IDENTITY_DOWNLINK:
                return parse_group_identity_list(bits)
        return []

    def set_groups(self, groups: List[GroupIdentity]) -> None:
        self.type3 = [(i, b) for i, b in self.type3
                      if i != GROUP_IDENTITY_DOWNLINK]
        self.type3.append((GROUP_IDENTITY_DOWNLINK,
                           build_group_identity_list(groups)))


@dataclass
class DAttachDetachGroupIdentityAck(_MmBase):
    group_identity_accept_reject: int = 0  # 1
    type3: List[Tuple[int, np.ndarray]] = field(default_factory=list)

    PDU_TYPE = DownlinkMmType.D_ATTACH_DETACH_GROUP_IDENTITY_ACK
    TYPE1 = [("group_identity_accept_reject", 1)]
    TYPE2 = []


@dataclass
class DMmStatus(_MmBase):
    status_downlink: int = 0               # 6
    type3: List[Tuple[int, np.ndarray]] = field(default_factory=list)

    PDU_TYPE = DownlinkMmType.D_MM_STATUS
    TYPE1 = [("status_downlink", 6)]
    TYPE2 = []


@dataclass
class GenericMm:
    pdu_type: int = 0
    body: np.ndarray = field(default_factory=lambda: np.zeros(0, np.uint8))

    @property
    def name(self) -> str:
        return f"MM-{self.pdu_type}"


_REGISTRY = {cls.PDU_TYPE: cls for cls in (
    DLocationUpdateAccept, DLocationUpdateCommand, DLocationUpdateReject,
    DLocationUpdateProceeding, DAttachDetachGroupIdentity,
    DAttachDetachGroupIdentityAck, DMmStatus)}


def parse_mm(bits):
    """Entity-PDU bits (after MLE PD=1) -> typed MM PDU or GenericMm."""
    cur = BitCursor(bits)
    pdu_type = cur.take(4)
    cls = _REGISTRY.get(pdu_type)
    if cls is None:
        return GenericMm(pdu_type, cur.take_bits(cur.remaining))
    return cls.parse(cur)
