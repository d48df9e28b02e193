"""SDS Transport Layer (EN 300 392-2 §29) over D/U-SDS-DATA type-4 user
data: SDS-TRANSFER with the text-messaging payload (PID 0x82), plus
generic pass-through for other protocol identifiers.

The reference implementation never parses SDS-TL structurally — it
byte-scans MAC payloads for PID lookalikes and guesses the text offset
(tetraear/core/protocol.py:824-1018); its 0x82 handling
skips a hard-coded 4 bytes.  Here the type-4 bit field from the CMCE
D-SDS-DATA PDU is decoded by the actual TL structure, and the encode
direction exists (the reference has none).

Layout (functional equivalent of §29.4/§29.5, TX/RX-consistent, pinned
by round-trip tests): protocol identifier (8); for PID >= 0x80 an SDS-TL
header: message type (4), delivery report request (2), service
selection (1), storage/forward-control flag (1), message reference (8),
then per-PID user data.  Text messaging (PID 0x82) user data: text
coding scheme (7), timestamp-used flag (1), optional 24-bit timestamp,
then the text in the selected coding (0 = GSM 03.38 7-bit packed,
1 = 8-bit Latin-1, 0x1A = UCS-2).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from tetraear_tpu_torch.protocol.bits import (BitCursor, bits_to_bytes,
                                        bytes_to_bits, pack_fields)
from tetraear_tpu_torch.protocol.sds import pack_gsm7, unpack_gsm7

__all__ = ["SdsTransfer", "MessageType", "Coding",
           "build_text_transfer", "parse_sds_tl"]


class MessageType:
    SDS_TRANSFER = 0
    SDS_REPORT = 1
    SDS_ACK = 2


class Coding:
    GSM7 = 0
    LATIN1 = 1
    UCS2 = 0x1A


PID_TEXT = 0x82
PID_SIMPLE_TEXT = 0x02


@dataclass
class SdsTransfer:
    """A decoded SDS-TL PDU (or a non-TL short-form PID payload)."""
    protocol_id: int = PID_TEXT
    message_type: int = MessageType.SDS_TRANSFER
    delivery_report_request: int = 0
    service_selection: int = 0
    message_reference: int = 0
    coding_scheme: Optional[int] = None
    timestamp: Optional[int] = None
    text: Optional[str] = None
    user_data: bytes = b""            # raw payload when text is None

    def build(self) -> np.ndarray:
        pairs = [(self.protocol_id, 8)]
        if self.protocol_id >= 0x80:
            pairs += [(self.message_type, 4),
                      (self.delivery_report_request, 2),
                      (self.service_selection, 1),
                      (0, 1),   # forward-address flag (TX never sets it)
                      (self.message_reference, 8)]
        head = pack_fields(pairs)
        if self.protocol_id == PID_TEXT and self.text is not None:
            body = [pack_fields([
                (self.coding_scheme
                 if self.coding_scheme is not None else Coding.GSM7, 7),
                (int(self.timestamp is not None), 1)])]
            if self.timestamp is not None:
                body.append(pack_fields([(self.timestamp, 24)]))
            body.append(bytes_to_bits(_encode_text(
                self.text, self.coding_scheme or Coding.GSM7)))
            return np.concatenate([head] + body)
        return np.concatenate([head, bytes_to_bits(self.user_data)])


def _encode_text(text: str, coding: int) -> bytes:
    if coding == Coding.GSM7:
        return pack_gsm7(text)
    if coding == Coding.LATIN1:
        return text.encode("latin-1")
    if coding == Coding.UCS2:
        return text.encode("utf-16-be")
    raise ValueError(f"unsupported text coding {coding}")


def _decode_text(data: bytes, coding: int) -> Optional[str]:
    try:
        if coding == Coding.GSM7:
            text = unpack_gsm7(data)
            # GSM 03.38 padding ambiguity: when the packed text leaves
            # exactly 7 spare bits (7*septets ≡ 1 mod 8), the zero pad
            # decodes as a spurious trailing '@' — strip it (same
            # convention as SMS decoders; a real trailing '@' in such
            # lengths is indistinguishable on the wire)
            if text.endswith("@") and (len(data) * 8) % 7 == 0:
                text = text[:-1]
            return text
        if coding == Coding.LATIN1:
            return data.decode("latin-1")
        if coding == Coding.UCS2:
            return data.decode("utf-16-be")
    except Exception:
        return None
    return None


def build_text_transfer(text: str, coding: int = Coding.GSM7,
                        message_reference: int = 1,
                        timestamp: Optional[int] = None) -> np.ndarray:
    """Text -> SDS-TL SDS-TRANSFER bits (the D-SDS-DATA type-4 payload)."""
    return SdsTransfer(protocol_id=PID_TEXT,
                       message_reference=message_reference,
                       coding_scheme=coding, timestamp=timestamp,
                       text=text).build()


def parse_sds_tl(bits) -> SdsTransfer:
    """D/U-SDS-DATA type-4 user-data bits -> decoded SdsTransfer.

    PIDs below 0x80 have no TL header (short-form protocols); their
    payload is returned raw, with a Latin-1/GSM7 text attempt for the
    simple text protocol (PID 0x02).
    """
    cur = BitCursor(bits)
    t = SdsTransfer(protocol_id=cur.take(8))
    if t.protocol_id < 0x80:
        t.message_type = -1
        t.user_data = bits_to_bytes(cur.take_bits(cur.remaining
                                                  // 8 * 8))
        if t.protocol_id == PID_SIMPLE_TEXT and t.user_data:
            # simple text service: coding scheme octet then text
            t.coding_scheme = t.user_data[0] & 0x7F
            t.text = _decode_text(t.user_data[1:], t.coding_scheme)
        return t
    t.message_type = cur.take(4)
    t.delivery_report_request = cur.take(2)
    t.service_selection = cur.take(1)
    forward = cur.take(1)
    t.message_reference = cur.take(8)
    if forward:
        # forward-address element: type (3) + 24-bit address (skipped)
        cur.take(3)
        cur.take(24)
    if t.protocol_id == PID_TEXT and t.message_type == \
            MessageType.SDS_TRANSFER:
        t.coding_scheme = cur.take(7)
        ts_flag = cur.take(1)
        if ts_flag:
            t.timestamp = cur.take(24)
        payload = bits_to_bytes(cur.take_bits(cur.remaining // 8 * 8))
        t.user_data = payload
        t.text = _decode_text(payload, t.coding_scheme)
    else:
        t.user_data = bits_to_bytes(cur.take_bits(cur.remaining
                                                  // 8 * 8))
    return t
