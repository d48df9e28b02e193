"""MLE layer (EN 300 392-2 §18): protocol-discriminator routing between
the MAC's TM-SDU and the layer-3 entities (MM, CMCE, SNDCP).

For MM/CMCE/SNDCP the MLE service is transparent — the TM-SDU is the
3-bit protocol discriminator followed directly by the entity's PDU
(§18.4.1).  PD=5 addresses the MLE protocol itself (D-NWRK-BROADCAST
etc.), which we surface as opaque bits.

The reference implementation has no layer 3 at all — its "call metadata"
and SDS extraction are byte heuristics over raw MAC payload bytes
(tetraear/core/protocol.py:597-1018).  The etsi profile
routes real PDUs through here instead.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from tetraear_tpu_torch.protocol.bits import (BitCursor, as_bit_array,
                                        pack_fields)

__all__ = ["PD", "wrap_mle", "unwrap_mle", "MlePdu", "MlePduType",
           "NeighbourCell", "DNwrkBroadcast", "parse_mle_pdu"]


class PD:
    """3-bit MLE protocol discriminator values (§18.5.21)."""
    RESERVED = 0
    MM = 1
    CMCE = 2
    SNDCP = 4
    MLE = 5
    TETRA_MGMT = 6
    TESTING = 7

    NAMES = {0: "reserved", 1: "MM", 2: "CMCE", 3: "reserved3",
             4: "SNDCP", 5: "MLE", 6: "TETRA-mgmt", 7: "testing"}


@dataclass
class MlePdu:
    """An MLE-protocol (PD=5) or otherwise unrouted SDU, kept opaque."""
    pd: int
    sdu: np.ndarray

    @property
    def pd_name(self) -> str:
        return PD.NAMES.get(self.pd, "?")


class MlePduType:
    """3-bit MLE-protocol (PD=5) PDU types (§18.5.x)."""
    D_NEW_CELL = 0
    D_PREPARE_FAIL = 1
    D_NWRK_BROADCAST = 2
    D_RESTORE_ACK = 4
    D_RESTORE_FAIL = 5


@dataclass
class NeighbourCell:
    """One neighbour-cell information element of D-NWRK-BROADCAST
    (§18.5.17 functional equivalent, widths documented inline and
    TX/RX-consistency pinned by tests)."""
    cell_identifier: int = 0      # 5
    cell_reselection_types: int = 0   # 2
    synchronized: int = 0         # 1 (neighbour cell synchronized)
    cell_load: int = 0            # 2
    main_carrier: int = 0         # 12
    extended_flag: int = 0        # 1 (-> band 4, offset 2, duplex 3, rev 1)
    frequency_band: int = 0
    offset: int = 0
    duplex_spacing: int = 0
    reverse_operation: int = 0
    la_flag: int = 0              # 1 (-> location area 14)
    location_area: int = 0

    def build(self) -> np.ndarray:
        pairs = [(self.cell_identifier, 5), (self.cell_reselection_types, 2),
                 (self.synchronized, 1), (self.cell_load, 2),
                 (self.main_carrier, 12), (self.extended_flag, 1)]
        if self.extended_flag:
            pairs += [(self.frequency_band, 4), (self.offset, 2),
                      (self.duplex_spacing, 3), (self.reverse_operation, 1)]
        pairs.append((self.la_flag, 1))
        if self.la_flag:
            pairs.append((self.location_area, 14))
        return pack_fields(pairs)

    @classmethod
    def parse(cls, cur: BitCursor) -> "NeighbourCell":
        n = cls(cell_identifier=cur.take(5),
                cell_reselection_types=cur.take(2),
                synchronized=cur.take(1), cell_load=cur.take(2),
                main_carrier=cur.take(12), extended_flag=cur.take(1))
        if n.extended_flag:
            n.frequency_band = cur.take(4)
            n.offset = cur.take(2)
            n.duplex_spacing = cur.take(3)
            n.reverse_operation = cur.take(1)
        n.la_flag = cur.take(1)
        if n.la_flag:
            n.location_area = cur.take(14)
        return n


@dataclass
class DNwrkBroadcast:
    """D-NWRK-BROADCAST (§18.4.1.4.1): cell re-selection parameters and
    the neighbour-cell list — what makes a scanning receiver aware of
    the rest of the network without sweeping the band."""
    cell_reselect_parameters: int = 0    # 16
    cell_load_ca: int = 0                # 2
    tetra_network_time: Optional[int] = None   # 48 (type-2)
    neighbours: List[NeighbourCell] = field(default_factory=list)

    PDU_TYPE = MlePduType.D_NWRK_BROADCAST

    def build(self) -> np.ndarray:
        parts = [pack_fields([(self.PDU_TYPE, 3),
                              (self.cell_reselect_parameters, 16),
                              (self.cell_load_ca, 2)])]
        # O-bit + P-bits: network time, then neighbour count + elements
        any_opt = self.tetra_network_time is not None or self.neighbours
        parts.append(pack_fields([(1 if any_opt else 0, 1)]))
        if any_opt:
            if self.tetra_network_time is not None:
                parts.append(pack_fields([(1, 1),
                                          (self.tetra_network_time, 48)]))
            else:
                parts.append(pack_fields([(0, 1)]))
            if self.neighbours:
                parts.append(pack_fields([(1, 1),
                                          (len(self.neighbours), 4)]))
                parts += [n.build() for n in self.neighbours]
            else:
                parts.append(pack_fields([(0, 1)]))
        return np.concatenate(parts)

    @classmethod
    def parse(cls, cur: BitCursor) -> "DNwrkBroadcast":
        p = cls(cell_reselect_parameters=cur.take(16),
                cell_load_ca=cur.take(2))
        if cur.remaining >= 1 and cur.take(1):
            if cur.take(1):
                p.tetra_network_time = cur.take(48)
            if cur.take(1):
                count = cur.take(4)
                p.neighbours = [NeighbourCell.parse(cur)
                                for _ in range(count)]
        return p

    @property
    def name(self) -> str:
        return "DNwrkBroadcast"


def parse_mle_pdu(bits):
    """MLE-protocol (PD=5) entity bits -> typed PDU or opaque MlePdu."""
    cur = BitCursor(bits)
    pdu_type = cur.take(3)
    if pdu_type == MlePduType.D_NWRK_BROADCAST:
        return DNwrkBroadcast.parse(cur)
    return MlePdu(PD.MLE, cur.take_bits(cur.remaining))


def wrap_mle(pd: int, sdu_bits) -> np.ndarray:
    """Prefix an entity PDU with its protocol discriminator."""
    return np.concatenate([pack_fields([(pd, 3)]), as_bit_array(sdu_bits)])


def unwrap_mle(tm_sdu) -> Tuple[int, np.ndarray]:
    """TM-SDU -> (protocol discriminator, entity PDU bits)."""
    bits = as_bit_array(tm_sdu)
    if bits.size < 3:
        raise ValueError("TM-SDU too short for an MLE header")
    pd = (int(bits[0]) << 2) | (int(bits[1]) << 1) | int(bits[2])
    return pd, bits[3:]
