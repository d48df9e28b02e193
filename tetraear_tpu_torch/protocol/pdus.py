"""ETSI broadcast PDUs carried by the downlink control channels
(EN 300 392-2 §21): SYNC (BSCH), SYSINFO (BNCH on SCH/HD) and
ACCESS-ASSIGN (AACH).

These are exact-width bit codecs: `build_*` produces the type-1 bit block
the channel coder consumes (ops/channel_coding.py geometry: BSCH 60,
SCH/HD 124, AACH 14) and `parse_*` inverts it.  Round-trip identity is
pinned by tests/unit/test_bursts.py.

Field maps follow EN 300 392-2 §21.4.4.2 (SYNC), §21.4.4.1 (SYSINFO) and
§21.4.7 (ACCESS-ASSIGN).  The reference implementation parses none of
these — its SYSINFO handling is a heuristic scan for plausible MCC/MNC
inside raw MAC bits (tetraear/core/protocol.py:476-540);
the `etsi` profile gets the real broadcast layer, and the parsed
MCC/MNC/colour-code here is what keys the cell scrambling sequence
(ops/scramble.extended_colour_code).
"""

from __future__ import annotations

from dataclasses import dataclass, fields as dc_fields
from typing import List, Tuple

import numpy as np

from tetraear_tpu_torch.protocol.bits import as_bit_array

__all__ = ["SyncPDU", "SysinfoPDU", "AccessAssignPDU"]


def _pack(pairs: List[Tuple[int, int]]) -> np.ndarray:
    """[(value, width), ...] -> uint8 bit array (big-endian per field)."""
    out = []
    for value, width in pairs:
        v = int(value) & ((1 << width) - 1)
        out.extend((v >> (width - 1 - i)) & 1 for i in range(width))
    return np.asarray(out, dtype=np.uint8)


class _Cursor:
    def __init__(self, bits):
        self.bits = as_bit_array(bits)
        self.pos = 0

    def take(self, width: int) -> int:
        v = 0
        for b in self.bits[self.pos:self.pos + width]:
            v = (v << 1) | int(b)
        self.pos += width
        return v


@dataclass
class SyncPDU:
    """SYNC PDU, 60 bits on BSCH: MAC part (31) + D-MLE-SYNC (29)."""

    system_code: int = 0          # 4  (0000 = EN 300 392-2 V+D)
    colour_code: int = 1          # 6
    timeslot: int = 0             # 2  (TN-1, i.e. 0..3 for TN 1..4)
    frame_number: int = 1         # 5  (1..18)
    multiframe_number: int = 1    # 6  (1..60)
    sharing_mode: int = 0         # 2
    ts_reserved_frames: int = 0   # 3
    uplane_dtx: int = 0           # 1
    frame18_extension: int = 0    # 1
    reserved: int = 0             # 1
    mcc: int = 0                  # 10 — D-MLE-SYNC from here down
    mnc: int = 0                  # 14
    neighbour_cell_broadcast: int = 0  # 2
    cell_service_level: int = 0   # 2
    late_entry_info: int = 0      # 1

    WIDTHS = (4, 6, 2, 5, 6, 2, 3, 1, 1, 1, 10, 14, 2, 2, 1)
    NUM_BITS = 60

    def build(self) -> np.ndarray:
        vals = [getattr(self, f.name) for f in dc_fields(self)]
        bits = _pack(list(zip(vals, self.WIDTHS)))
        assert bits.size == self.NUM_BITS
        return bits

    @classmethod
    def parse(cls, bits) -> "SyncPDU":
        cur = _Cursor(bits)
        vals = [cur.take(w) for w in cls.WIDTHS]
        return cls(*vals)


@dataclass
class SysinfoPDU:
    """SYSINFO PDU, 124 bits on BNCH/SCH-HD: MAC broadcast part +
    D-MLE-SYSINFO (42 bits: LA 14 | subscriber class 16 | BS service 12)."""

    pdu_type: int = 2             # 2  (MAC broadcast)
    broadcast_type: int = 0       # 2  (0 = SYSINFO)
    main_carrier: int = 0         # 12
    frequency_band: int = 0       # 4
    offset: int = 0               # 2
    duplex_spacing: int = 0       # 3
    reverse_operation: int = 0    # 1
    num_common_scch: int = 0      # 2
    ms_txpwr_max_cell: int = 0    # 3
    rxlev_access_min: int = 0     # 4
    access_parameter: int = 0     # 4
    radio_downlink_timeout: int = 0  # 4
    hyperframe_cipher_flag: int = 0  # 1
    hyperframe_number: int = 0    # 16 (or CCK id when flag = 1)
    optional_field_flag: int = 0  # 2
    frame_bitmap: int = 0         # 20 (TS_COMMON_FRAMES / access codes)
    location_area: int = 0        # 14 — D-MLE-SYSINFO from here down
    subscriber_class: int = 0xFFFF  # 16
    bs_service_details: int = 0   # 12

    WIDTHS = (2, 2, 12, 4, 2, 3, 1, 2, 3, 4, 4, 4, 1, 16, 2, 20, 14, 16, 12)
    NUM_BITS = 124

    def build(self) -> np.ndarray:
        vals = [getattr(self, f.name) for f in dc_fields(self)]
        bits = _pack(list(zip(vals, self.WIDTHS)))
        assert bits.size == self.NUM_BITS
        return bits

    @classmethod
    def parse(cls, bits) -> "SysinfoPDU":
        cur = _Cursor(bits)
        vals = [cur.take(w) for w in cls.WIDTHS]
        return cls(*vals)

    @property
    def downlink_frequency_hz(self) -> float:
        """Main carrier frequency implied by band/carrier/offset."""
        base = self.frequency_band * 100e6
        off = {0: 0.0, 1: +6250.0, 2: -6250.0, 3: +12500.0}[self.offset]
        return base + self.main_carrier * 25e3 + off


# Downlink usage markers (header semantics, frames 1..17).
DL_USAGE = {0: "unallocated", 1: "assigned_control", 2: "common_control",
            3: "traffic"}


@dataclass
class AccessAssignPDU:
    """ACCESS-ASSIGN PDU, 14 bits on AACH.

    header (2) | field1 (6) | field2 (6).  On the downlink, frames 1..17:
    header encodes the downlink usage for this slot and the two fields
    carry access-field / usage-marker values; frame 18 is common control
    by definition.
    """

    header: int = 2               # default: common control
    field1: int = 0
    field2: int = 0

    NUM_BITS = 14

    def build(self) -> np.ndarray:
        return _pack([(self.header, 2), (self.field1, 6), (self.field2, 6)])

    @classmethod
    def parse(cls, bits) -> "AccessAssignPDU":
        cur = _Cursor(bits)
        return cls(cur.take(2), cur.take(6), cur.take(6))

    @property
    def downlink_usage(self) -> str:
        return DL_USAGE[self.header]
