"""Readability scoring / filtering for decoded SDS text (behavioral parity
with the reference ops scripts: listen_clear.py:53-63,
bruteforce_keys.py:25-62, decrypt_capture.py:36-59)."""

from __future__ import annotations

_ALLOWED = set("ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz"
               "0123456789 .,!?;:()[]/@#$%&*+-=_\"'")


def is_pure_ascii(text: str) -> bool:
    """Strict clear-text gate (listen_clear.py:53-63)."""
    if not text or len(text) < 5:
        return False
    clean = (text.replace("[GSM7]", "").replace("[TXT]", "")
             .replace("[LOC]", "").strip())
    if len(clean) < 5:
        return False
    valid = sum(1 for c in clean if c in _ALLOWED)
    alnum = sum(1 for c in clean if c.isalnum())
    return (valid / len(clean) > 0.8 and alnum / len(clean) > 0.5
            and len(clean.split()) >= 2)


def score_text(text: str) -> float:
    """Brute-force candidate ranking (bruteforce_keys.py:25-62)."""
    if not text:
        return 0.0
    clean = text.replace("[GSM7]", "").replace("[TXT]", "").strip()
    if len(clean) < 3:
        return 0.0
    ascii_alnum = sum(1 for c in clean if c.isalnum() and ord(c) < 128)
    spaces = sum(1 for c in clean if c == " ")
    weird = sum(1 for c in clean if ord(c) > 127)
    total = len(clean)
    score = (ascii_alnum / total) * 2.0 + (spaces / total) * 0.5 \
        - (weird / total) * 1.5
    if spaces > 0:
        score += 0.5
    if any(c.isupper() for c in clean) and any(c.islower() for c in clean):
        score += 0.3
    return max(0.0, score)


def score_readability(text: str) -> float:
    """Decrypt-capture readability (decrypt_capture.py:36-59)."""
    if not text or len(text) < 4:
        return 0.0
    clean = text.replace("[GSM7]", "").replace("[TXT]", "").strip()
    if not clean:
        return 0.0
    good = sum(1 for c in clean
               if 32 <= ord(c) < 127 and (c.isalnum() or c in " .,!?-"))
    bad = sum(1 for c in clean if ord(c) > 127)
    total = len(clean)
    score = (good / total) * 3.0 - (bad / total) * 2.0
    if " " in clean:
        score += 1.0
    if clean.count("@") > total * 0.3:
        score -= 1.0
    return max(0.0, score)
