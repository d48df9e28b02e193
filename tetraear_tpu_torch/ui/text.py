"""Readable-text gating and display formatting helpers (behavioral parity
with tetraear/ui/modern.py:204-321, ASCII-safe variants of the icons)."""

from __future__ import annotations

from typing import Optional

_PREFIXES = ["[GSM7]", "[TXT]", "[SDS]", "[SDS-1]", "[SDS-GSM]", "[LIP]",
             "[LOC]", "[GPS]", "[BIN-ENC]", "[BIN]", '"']

_GSM7_SPECIALS = set(
    "ΩΔΣΘΞΛΓΦΨΠåæÅÆØøÇÉÑÜßìÌíÍîÎïÏòÒóÓôÔõÕöÖùÙúÚûÛüÜ¿¡¢£¤¥¦§¨©ª«¬®¯°±²³´µ¶·¸¹º»¼½¾")


def is_readable_text(text: str) -> bool:
    """Strict human-readability gate (modern.py:204-271)."""
    if not text or len(text) < 3:
        return False
    clean = text
    for prefix in _PREFIXES:
        clean = clean.replace(prefix, "")
    clean = clean.strip()
    if len(clean) < 3:
        return False
    if any(c in _GSM7_SPECIALS for c in clean):
        return False
    high = sum(1 for c in clean if ord(c) > 127)
    if high / len(clean) > 0.05:
        return False
    if any(ord(c) < 32 and c not in "\n\r\t" for c in clean):
        return False
    ascii_readable = sum(1 for c in clean
                         if (c.isalnum() or c.isspace()) and ord(c) < 128)
    if ascii_readable / len(clean) < 0.70:
        return False
    alnum = sum(1 for c in clean if c.isalnum())
    if alnum / len(clean) < 0.50:
        return False
    if len(clean) > 10:
        lowercase = sum(1 for c in clean if c.islower())
        if lowercase / len(clean) < 0.20:
            return False
        words = clean.split()
        if len(words) > 1:
            valid = sum(1 for w in words if w and
                        sum(1 for c in w if c.isalpha()) / len(w) > 0.5)
            if valid / len(words) < 0.5:
                return False
    else:
        if not any(c.islower() for c in clean):
            if not (len(clean) <= 4 and clean.isupper() and clean.isalpha()):
                return False
    return True


def format_location_data(frame: dict) -> Optional[str]:
    """modern.py:274-290."""
    text = frame.get("decoded_text", "") or frame.get("sds_message", "")
    if "[LIP]" in text or "[LOC]" in text:
        if "Lat:" in text and "Lon:" in text:
            return f"[POS] {text}"
        hex_data = text.split(":", 1)[-1].strip() if ":" in text else text
        return f"[POS] Location Data: {hex_data[:40]}..."
    if "[GPS]" in text:
        return f"[GPS] {text}"
    return None


def format_binary_metadata(frame: dict) -> Optional[str]:
    """modern.py:293-321."""
    if "[BIN-ENC]" in str(frame.get("decoded_text", "")):
        text = frame.get("decoded_text", "")
        if "bytes" in text:
            return f"[ENC] Encrypted Binary Data ({text})"
        return "[ENC] Encrypted Binary Data"
    type_name = frame.get("type_name", "")
    if type_name == "MAC-RESOURCE":
        info = frame.get("additional_info", {})
        if info.get("talkgroup"):
            return f"[RES] Resource Allocation: TG {info['talkgroup']}"
        return "[RES] Resource Allocation"
    if type_name == "MAC-BROADCAST":
        info = frame.get("additional_info", {})
        desc = info.get("description", "")
        if "Broadcast" in desc or "info" in desc.lower():
            return f"[BCN] Network Broadcast: {desc}"
        return "[BCN] Network Broadcast"
    if type_name in ("MAC-FRAG", "MAC-END/RES"):
        return f"[FRG] {type_name} (Fragment/Control)"
    return None
