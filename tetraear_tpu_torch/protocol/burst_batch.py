"""The stateless half of the frame decode, over a batch of slots.

`read_slots` takes F slots at once, each as its first frame bits and its
255 dibit symbols, and reads what depends on the slot's bits alone: the
frame header's PDU type, encryption mode and '0101...' string; the burst
(`read_bursts`: bit expansion, the mid-burst sync-word match, block
slicing, the soft-CRC verdict grouped by data length); and the MAC
header of the burst's data (`mac_headers`: type, encryption mode, fill
bit, address, length, the data bytes, a SYSINFO broadcast's MCC / MNC /
colour code; each row's gates on its fields, the bytes packed once for
each PDU type).  Nothing here touches parser state:
`TetraProtocolParser` and `TetraDecoder.decode_slot` keep the stateful
tail per frame (statistics, fragment reassembly, network state, call
metadata, SDS, decryption), and their one-slot entries (`parse_burst`,
`parse_mac_pdu`, `decode_frame`) are batches of one through the same
functions.  Fields are read with dot products against powers of two over
the batch; values come out as Python ints and bools.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np

from tetraear_tpu_torch import constants as C
from tetraear_tpu_torch.ops.crc import soft_crc_check_rows
from tetraear_tpu_torch.protocol.types import PDUType

HEADER_BITS = 32
_SYNC_WORDS = np.stack([C.SYNC_CONTINUOUS_DOWNLINK,
                        C.SYNC_DISCONTINUOUS_DOWNLINK]).astype(np.uint8)
_MID = C.BITS_PER_SLOT // 2                       # the sync word's place
_DIBITS = np.array([[0, 0], [0, 1], [1, 0], [1, 1]], np.uint8)  # MSB first
# MAC PDU type by its 2-bit field, and where each type's data starts
_PDU_TYPES = (PDUType.MAC_RESOURCE, PDUType.MAC_FRAG, PDUType.MAC_BROADCAST,
              PDUType.MAC_END)
_DATA_START = (35, 5, 4, 11)
# the header fields a MAC PDU's first 35 bits hold, as [first, last) bit:
# type, encryption mode, fill bit, address, MAC-RESOURCE length, MAC-END
# length, MCC, MNC, colour code; one product of the bits with their
# powers of two reads them all
_FIELDS = ((0, 2), (2, 4), (4, 5), (5, 29), (29, 35), (5, 11), (4, 14),
           (14, 28), (28, 34))
_WEIGHTS = np.zeros((35, len(_FIELDS)))
for _j, (_lo, _hi) in enumerate(_FIELDS):
    _WEIGHTS[_lo:_hi, _j] = 2.0 ** np.arange(_hi - _lo - 1, -1, -1)


class MacHeader(NamedTuple):
    """What `parse_mac_pdu` reads from a PDU's bits alone.  `pdu_type` is
    None where the parse ends before it touches parser state (too short,
    a length past the data, a truncated SYSINFO); `network` is a SYSINFO
    broadcast's (MCC, MNC, colour code), at bits 4..34."""
    pdu_type: Optional[PDUType]
    encryption_mode: int = 0
    fill_bits: int = 0
    address: Optional[int] = None
    length: int = 0
    data: bytes = b""
    network: Optional[tuple] = None


REJECTED = MacHeader(None)


def mac_headers(bits: np.ndarray) -> List[MacHeader]:
    """The MAC header of each row of (F, D) 0/1 uint8 bits, as
    `TetraProtocolParser.parse_mac_pdu` reads it (protocol.py:349-596):
    the fields of every row from one product, each row's gates on them,
    and the data bytes packed once for each PDU type."""
    f, d = bits.shape
    out = [REJECTED] * f
    if d < 8:
        return out
    # the fields past the data's end read zeros; the gates drop those rows
    head = bits[:, :35] if d >= 35 else np.pad(bits, ((0, 0), (0, 35 - d)))
    fields = (head @ _WEIGHTS).astype(np.int64).tolist()  # exact: < 2**24
    rows, kept = ([], [], [], []), []
    for i, (k, e, fb, a, res_length, end_length, *net) in enumerate(fields):
        left = d - _DATA_START[k]                  # data bits after the header
        length = res_length if k == 0 else end_length if k == 3 else 0
        if left < 0 or 8 * length > left + 16 or (k == 2 and e == 0
                                                  and d < 34):
            continue
        nbytes = length if 0 < 8 * length <= left else (left + 7) // 8
        kept.append((i, k, len(rows[k]), e, fb, a, length, nbytes, net))
        rows[k].append(i)
    # each row's data: a slice of its type's bytes, packed at once
    packed, width = [b""] * 4, [0] * 4
    for k, lo in enumerate(_DATA_START):
        if rows[k]:
            block = np.packbits(bits[rows[k], lo:], axis=1)
            packed[k], width[k] = block.tobytes(), block.shape[1]
    for i, k, j, e, fb, a, length, nbytes, net in kept:
        lo = j * width[k]
        out[i] = MacHeader(_PDU_TYPES[k], e, 0 if k == 2 else fb,
                           a if k == 0 else None, length,
                           packed[k][lo:lo + nbytes],
                           tuple(net) if k == 2 and e == 0 else None)
    return out


def _blocks(bits: np.ndarray) -> np.ndarray:
    """A normal burst's data: blocks 1 and 2 of each row, (F, 216)."""
    return np.concatenate([bits[:, C.BURST_BLOCK1[0]:C.BURST_BLOCK1[1]],
                           bits[:, C.BURST_BLOCK2[0]:C.BURST_BLOCK2[1]]],
                          axis=1)


class Bursts(NamedTuple):
    """F bursts read at once: `bits` (F, 510) uint8, `sync` (F,) bool
    (a sync burst), `crc_ok` (F,) bool, and the data bits grouped by
    length (`groups`: (rows, (n, D) bits), the normal bursts' 216 bits,
    the sync bursts' 510)."""
    bits: np.ndarray
    sync: np.ndarray
    crc_ok: np.ndarray
    groups: list

    def data_bits(self, i: int) -> np.ndarray:
        if self.sync[i]:
            return self.bits[i]
        return _blocks(self.bits[i:i + 1])[0]

    def training_sequence(self, i: int) -> np.ndarray:
        lo, hi = C.BURST_TRAINING_SYNC if self.sync[i] else C.BURST_TRAINING
        return self.bits[i, lo:hi]


def read_bursts(symbols: np.ndarray, crc_ok=None) -> Bursts:
    """(F, 255) dibit symbols -> Bursts, as `parse_burst` slices one
    (protocol.py:192-329): bits MSB first, a sync burst where more than
    80 % of the 22 mid-burst bits match either downlink sync word, the
    data blocks 1 and 2 of a normal burst or all 510 bits of a sync
    burst, and the soft-CRC verdict on them unless `crc_ok` gives it."""
    s = np.asarray(symbols)
    if s.dtype.kind not in "biu":
        s = s.astype(np.int64)
    f = s.shape[0]
    bits = _DIBITS.take(s & 3, axis=0).reshape(f, 2 * s.shape[1])
    mid = bits[:, None, _MID:_MID + 22] == _SYNC_WORDS
    sync = mid.sum(axis=2).max(axis=1) / 22 > 0.8
    normal = (~sync).nonzero()[0]
    groups = []
    if normal.size:
        groups.append((normal, _blocks(bits[normal])))
    if normal.size < f:
        rows = sync.nonzero()[0]
        groups.append((rows, bits[rows]))
    if crc_ok is None:
        crc_ok = np.zeros(f, bool)
        for rows, data in groups:
            crc_ok[rows] = soft_crc_check_rows(data)
    return Bursts(bits, sync, np.asarray(crc_ok, bool).reshape(f), groups)


class Slots(NamedTuple):
    """`read_slots`' per-slot fields, as Python values: the frame
    header's `pdu_type`, `encryption_mode` and `header` string; the
    burst's `crc_ok` and its data's `mac` header (None where the slot
    came with no burst)."""
    pdu_type: list
    encryption_mode: list
    header: list
    crc_ok: Optional[list]
    mac: Optional[list]


def read_slots(head: np.ndarray, symbols: Optional[np.ndarray]) -> Slots:
    """F slots at once: `head` (F, >= 32) their first frame bits,
    `symbols` (F, 255) their dibit symbols, or None for slots with no
    burst to read."""
    head = np.asarray(head)[:, :HEADER_BITS]
    f = head.shape[0]
    first = head[:, :4].astype(np.int64)
    text = ((head.astype(np.uint8) & 1) + ord("0")).tobytes().decode("ascii")
    crc_ok = mac = None
    if symbols is not None:
        bursts = read_bursts(symbols)
        crc_ok, mac = bursts.crc_ok.tolist(), [REJECTED] * f
        for rows, data in bursts.groups:
            for row, header in zip(rows.tolist(), mac_headers(data)):
                mac[row] = header
    return Slots(pdu_type=((first[:, 0] << 1) | first[:, 1]).tolist(),
                 encryption_mode=((first[:, 2] << 1) | first[:, 3]).tolist(),
                 header=[text[i:i + HEADER_BITS]
                         for i in range(0, f * HEADER_BITS, HEADER_BITS)],
                 crc_ok=crc_ok, mac=mac)
