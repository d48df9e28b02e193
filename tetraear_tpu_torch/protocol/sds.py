"""SDS payload decoding: SDS-1 text, GSM 03.38 7-bit, SDS-TL PIDs, binary
previews.  Behavioral parity with tetraear/core/protocol.py:802-1235.

Stateless functions; the parser facade wires them to its stats counters.
"""

from __future__ import annotations

from typing import List, Optional

from tetraear_tpu_torch.protocol import lip as lip_mod

# GSM 03.38 default alphabet (protocol.py:1090-1099)
GSM7_DEFAULT_ALPHABET = [
    "@", "£", "$", "¥", "è", "é", "ù", "ì", "ò", "Ç", "\n", "Ø", "ø", "\r", "Å", "å",
    "Δ", "_", "Φ", "Γ", "Λ", "Ω", "Π", "Ψ", "Σ", "Θ", "Ξ", "\x1b", "Æ", "æ", "ß", "É",
    " ", "!", "\"", "#", "¤", "%", "&", "'", "(", ")", "*", "+", ",", "-", ".", "/",
    "0", "1", "2", "3", "4", "5", "6", "7", "8", "9", ":", ";", "<", "=", ">", "?",
    "¡", "A", "B", "C", "D", "E", "F", "G", "H", "I", "J", "K", "L", "M", "N", "O",
    "P", "Q", "R", "S", "T", "U", "V", "W", "X", "Y", "Z", "Ä", "Ö", "Ñ", "Ü", "§",
    "¿", "a", "b", "c", "d", "e", "f", "g", "h", "i", "j", "k", "l", "m", "n", "o",
    "p", "q", "r", "s", "t", "u", "v", "w", "x", "y", "z", "ä", "ö", "ñ", "ü", "à",
]

GSM7_EXTENSION_TABLE = {
    0x0A: "\f", 0x14: "^", 0x28: "{", 0x29: "}", 0x2F: "\\",
    0x3C: "[", 0x3D: "~", 0x3E: "]", 0x40: "|", 0x65: "€",
}


def _gsm_map(code: int) -> str:
    if 0 <= code < len(GSM7_DEFAULT_ALPHABET):
        ch = GSM7_DEFAULT_ALPHABET[code]
        return "" if ch == "\x1b" else ch
    return ""


_GSM7_REVERSE = {ch: i for i, ch in enumerate(GSM7_DEFAULT_ALPHABET)
                 if ch != "\x1b"}
_GSM7_EXT_REVERSE = {ch: code for code, ch in GSM7_EXTENSION_TABLE.items()}


def pack_gsm7(text: str) -> bytes:
    """GSM 03.38 7-bit pack, LSB-first septets — exact inverse of
    ``unpack_gsm7`` (pinned by the repo's golden vector: "hellohello" ->
    E8329BFD4697D9EC37, reference test_gsm7.py:8-13).  Characters outside
    the default + extension alphabets raise ``ValueError``.  Used by the
    SDS-TL transmitter (protocol/sds_tl.py); the reference has no encode
    direction at all.
    """
    septets: List[int] = []
    for ch in text:
        if ch in _GSM7_REVERSE:
            septets.append(_GSM7_REVERSE[ch])
        elif ch in _GSM7_EXT_REVERSE:
            septets.extend([0x1B, _GSM7_EXT_REVERSE[ch]])
        else:
            raise ValueError(f"not GSM7-encodable: {ch!r}")
    bits: List[int] = []
    for code in septets:
        bits.extend((code >> i) & 1 for i in range(7))
    while len(bits) % 8:
        bits.append(0)
    out = bytearray()
    for base in range(0, len(bits), 8):
        b = 0
        for i in range(8):
            b |= bits[base + i] << i
        out.append(b)
    return bytes(out)


def unpack_gsm7(data: bytes, septet_count: Optional[int] = None,
                skip_bits: int = 0) -> str:
    """GSM 03.38 7-bit unpack, LSB-first septets (protocol.py:1114-1165)."""
    if not data:
        return ""
    bits: List[int] = []
    for b in data:
        for i in range(8):
            bits.append((b >> i) & 1)
    if skip_bits:
        if skip_bits >= len(bits):
            return ""
        bits = bits[skip_bits:]
    max_septets = len(bits) // 7
    if septet_count is None or septet_count > max_septets:
        septet_count = max_septets
    out: List[str] = []
    escaped = False
    for idx in range(septet_count):
        base = idx * 7
        code = 0
        for off in range(7):
            code |= bits[base + off] << off
        if escaped:
            out.append(GSM7_EXTENSION_TABLE.get(code, ""))
            escaped = False
        elif code == 0x1B:
            escaped = True
        else:
            out.append(_gsm_map(code))
    return "".join(out)


def unpack_gsm7_with_udh(data: bytes, septet_count: Optional[int] = None) -> str:
    """UDH-aware variant: first octet treated as UDHL (protocol.py:1167-1195)."""
    if not data or len(data) < 2:
        return ""
    udh_len = data[0]
    if udh_len <= 0:
        return ""
    udh_total = udh_len + 1
    if udh_total > len(data):
        return ""
    skip_bits = udh_total * 8
    payload_septets = None
    if septet_count is not None:
        udh_septets = (skip_bits + 6) // 7
        if septet_count > udh_septets:
            payload_septets = septet_count - udh_septets
    return unpack_gsm7(data, septet_count=payload_septets, skip_bits=skip_bits)


def score_text(text: str) -> float:
    """Plausibility score for candidate decodes (protocol.py:1204-1211)."""
    if not text:
        return 0.0
    printable = sum(1 for c in text if c.isprintable() and c not in "\x1b")
    alnum = sum(1 for c in text if c.isalnum() or c.isspace())
    alpha = sum(1 for c in text if c.isalpha())
    return (printable / len(text)) + (alnum / len(text)) + (0.5 if alpha > 0 else 0.0)


def is_valid_text(text: str, threshold: float = 0.8) -> bool:
    """Readability gate (protocol.py:1213-1235)."""
    if not text or len(text) < 2:
        return False
    clean = "".join(c for c in text if c not in "\n\r\t ")
    if not clean:
        return False
    printable = sum(1 for c in text if c.isprintable() or c in "\n\r\t")
    ratio = printable / len(text)
    if len(text) > 4 and text.count(text[0]) == len(text):
        return False
    alnum = sum(1 for c in text if c.isalnum() or c == " ")
    return ratio >= threshold and (alnum / len(text)) > 0.5


def _hex_preview(buf: bytes, max_bytes: int = 48) -> str:
    if len(buf) <= max_bytes:
        return buf.hex(" ").upper()
    return buf[:max_bytes].hex(" ").upper() + " ..."


def parse_sds_data(data: bytes, on_message=None) -> Optional[str]:
    """Decode an SDS payload; returns a tagged string or None.

    ``on_message`` is called once when a decoded data message should bump the
    ``data_messages`` stat (protocol.py increments inline).  Behavioral
    parity with protocol.py:802-1018 including tag strings and the [BIN]
    preview format.
    """
    notify = on_message or (lambda: None)
    if not data or len(data) < 1:
        return None
    data_stripped = data.rstrip(b"\x00")
    if not data_stripped:
        return None

    # SDS-1 text: 05 00 <len> <ascii...>
    if len(data) > 3 and data[0] == 0x05 and data[1] == 0x00:
        payload = data[3:].rstrip(b"\x00")
        try:
            text = payload.decode("ascii")
            if is_valid_text(text):
                notify()
                return f"[SDS-1] {text}"
        except Exception:
            pass

    # GSM 7-bit SDS: 07 00 <septets> <packed...>
    if len(data) > 3 and data[0] == 0x07 and data[1] == 0x00:
        candidates: List[str] = []
        septet_count = data[2]
        payload_3 = data[3:]
        if payload_3:
            max_septets = (len(payload_3) * 8) // 7
            if 0 < septet_count <= min(160, max_septets):
                candidates.append(unpack_gsm7(payload_3, septet_count=septet_count))
                candidates.append(unpack_gsm7_with_udh(payload_3,
                                                       septet_count=septet_count))
            candidates.append(unpack_gsm7(payload_3))
            candidates.append(unpack_gsm7_with_udh(payload_3))
        payload_2 = data[2:]
        if payload_2:
            candidates.append(unpack_gsm7(payload_2))
            candidates.append(unpack_gsm7_with_udh(payload_2))
        best, best_score = "", 0.0
        seen = set()
        for text in candidates:
            text = text.strip("\x00").strip()
            if not text or text in seen:
                continue
            seen.add(text)
            s = score_text(text)
            if s > best_score:
                best_score, best = s, text
        if best and is_valid_text(best, threshold=0.55):
            notify()
            return f"[SDS-GSM] {best}"

    # SDS-TL protocol identifiers
    pid = data[0]
    payload = data[1:].rstrip(b"\x00")
    if pid == 0x82:  # ISO 8859-1 text
        try:
            text = payload.decode("latin-1")
            if is_valid_text(text):
                notify()
                return f"[TXT] {text}"
        except Exception:
            pass
    elif pid == 0x03:  # ASCII text
        try:
            text = payload.decode("ascii")
            if is_valid_text(text):
                notify()
                return f"[TXT] {text}"
        except Exception:
            pass
    elif pid == 0x83:  # Location
        lip_text = lip_mod.parse_lip(payload)
        if lip_text:
            return f"[LIP] {lip_text}"
        return f"[LOC] Location Data: {payload.hex()}"
    elif pid == 0x0C:  # GPS
        lip_text = lip_mod.parse_lip(payload)
        if lip_text:
            return f"[LIP] {lip_text}"
        return f"[GPS] GPS Data: {payload.hex()}"

    # Fallback: printable-ratio text heuristics
    test_data = data_stripped
    printable_count = sum(1 for b in test_data if 32 <= b <= 126 or b in (10, 13))
    if len(test_data) > 0 and (printable_count / len(test_data)) > 0.6:
        try:
            text = None
            for encoding in ("utf-8", "latin-1", "ascii", "cp1252"):
                try:
                    text = test_data.decode(encoding, errors="strict")
                    if is_valid_text(text, threshold=0.6):
                        notify()
                        return f"[TXT] {text}"
                except Exception:
                    continue
            if not text:
                text = test_data.decode("latin-1", errors="replace")
                if is_valid_text(text, threshold=0.6):
                    notify()
                    return f"[TXT] {text}"
        except Exception:
            pass

    # Last-resort GSM7
    try:
        candidates = [unpack_gsm7(test_data), unpack_gsm7_with_udh(test_data)]
        best, best_score = "", 0.0
        seen = set()
        for text in candidates:
            text = text.strip("\x00").strip()
            if not text or text in seen:
                continue
            seen.add(text)
            s = score_text(text)
            if s > best_score:
                best_score, best = s, text
        if best and is_valid_text(best, threshold=0.55):
            notify()
            return f"[GSM7] {best}"
    except Exception:
        pass

    # high-entropy -> flagged as encrypted binary
    if len(test_data) > 8:
        unique_bytes = len(set(test_data))
        if unique_bytes / len(test_data) > 0.7:
            hex_preview = test_data[:32].hex(" ").upper()
            if len(test_data) > 32:
                hex_preview += "..."
            return (f"[BIN-ENC] SDS (Binary/Encrypted) - {len(test_data)} bytes"
                    f" | {hex_preview}")

    # structured binary preview: PID + hex + optional ASCII/TLV/u16 views
    pid = data_stripped[0]
    payload = data_stripped[1:]
    parts = [f"PID=0x{pid:02X}", f"HEX={_hex_preview(data_stripped, max_bytes=32)}"]
    if payload:
        printable_count = sum(1 for b in payload if 32 <= b <= 126 or b in (10, 13, 9))
        if (printable_count / len(payload)) >= 0.85:
            try:
                ascii_text = (payload.decode("latin-1", errors="replace")
                              .replace("\r", "").replace("\x00", ""))
                ascii_text = "".join(
                    c for c in ascii_text if c.isprintable() or c in "\n\t").strip()
                if ascii_text:
                    parts.append(f'ASCII="{ascii_text[:60]}"')
            except Exception:
                pass
        tlv_items = []
        idx = 0
        while idx + 2 <= len(payload):
            tag = payload[idx]
            length = payload[idx + 1]
            if length == 0 or idx + 2 + length > len(payload):
                break
            value = payload[idx + 2: idx + 2 + length]
            tlv_items.append(f"{tag:02X}:{length}={_hex_preview(value, max_bytes=12)}")
            idx += 2 + length
            if len(tlv_items) >= 4:
                break
        if tlv_items and idx >= max(3, int(len(payload) * 0.75)):
            parts.append("TLV=" + " ".join(tlv_items))
        if len(payload) in (2, 4, 6, 8, 10, 12) and len(payload) <= 12:
            words_le = [int.from_bytes(payload[i:i + 2], "little")
                        for i in range(0, len(payload), 2)]
            words_be = [int.from_bytes(payload[i:i + 2], "big")
                        for i in range(0, len(payload), 2)]
            parts.append("u16le=" + ",".join(f"0x{w:04X}" for w in words_le))
            parts.append("u16be=" + ",".join(f"0x{w:04X}" for w in words_be))
    return "[BIN] " + " | ".join(parts)
