"""Frame authenticity validation — a data-driven penalty pipeline.

Behavioral parity with the reference gate (tetraear/core/validator.py:
11-181): the multiplicative penalty constants, their application ORDER,
and the issue strings are the conformance contract (pinned bit-for-bit
by tests/conformance/test_reference_ab.py::TestValidatorAB), but the
engine here is a declarative rule table folded over the frame —
each rule inspects the frame (and the validator's cross-frame state)
and returns a confidence factor plus an optional issue string.  Adding
or tuning a gate means editing PENALTY / appending to FRAME_RULES, not
threading another if-block through an imperative routine.
"""

from __future__ import annotations

import logging
from typing import Callable, Optional, Tuple

logger = logging.getLogger(__name__)

# Multiplicative penalty factors (reference values — the spec):
PENALTY = {
    "crc_failed": 0.3,          # validator.py:96  CRC gate
    "no_frame_type": 0.5,       # validator.py:101 structure gate
    "no_network_yet": 0.4,      # validator.py:122 no ID before any net seen
    "unknown_cipher": 0.7,      # validator.py:131 enc alg not TEA1-4
    "weak_decrypt": 0.6,        # validator.py:139 decrypt_confidence < 180
    "mnc_implausible": 0.5,     # validator.py:82  MNC > 999
}
# MCC plausibility ladder (validator.py:60-78): base -> European ->
# expected-country; a mismatch with the expected country lands between.
MCC_CONFIDENCE = {"base": 0.5, "european": 0.8, "expected": 0.95,
                  "mismatch": 0.6}
DECRYPT_CONFIDENCE_FLOOR = 180
ACCEPT_CONFIDENCE = 0.5         # validator.py:151: conf >= 0.5 and
ACCEPT_MAX_ISSUES = 2           # at most 2 issues


# A rule maps (frame, validator) -> (confidence factor, issue or None).
Rule = Callable[[dict, "TetraSignalValidator"],
                Tuple[float, Optional[str]]]
_PASS: Tuple[float, Optional[str]] = (1.0, None)


def _rule_crc(frame, v):
    if "crc_ok" in frame and not frame["crc_ok"]:
        return PENALTY["crc_failed"], "CRC failed"
    return _PASS


def _rule_frame_type(frame, v):
    if frame.get("type_name") is None:
        return PENALTY["no_frame_type"], "No frame type"
    return _PASS


def _network_id(frame):
    """MCC/MNC source precedence: call_metadata, else additional_info."""
    for key in ("call_metadata", "additional_info"):
        if key in frame:
            return frame[key].get("mcc"), frame[key].get("mnc")
    return None, None


def _rule_network(frame, v):
    """Network-ID plausibility — the one stateful rule: a frame with no
    ID is only suspicious before any valid network has been seen, and a
    hard-invalid MCC zeroes the confidence outright."""
    mcc, mnc = _network_id(frame)
    if mcc is None:
        if not v.detected_networks:
            return (PENALTY["no_network_yet"],
                    "No network ID and no valid network seen yet")
        return _PASS
    valid, mcc_conf, reason = v.validate_mcc_mnc(mcc, mnc)
    if not valid:
        return 0.0, reason
    # plausible but weak IDs surface their reason as an issue
    return mcc_conf, (reason if mcc_conf < 0.7 else None)


def _rule_cipher(frame, v):
    if frame.get("encrypted"):
        alg = frame.get("encryption_algorithm")
        if alg not in ("TEA1", "TEA2", "TEA3", "TEA4"):
            return PENALTY["unknown_cipher"], f"Unknown encryption: {alg}"
    return _PASS


def _rule_decrypt(frame, v):
    if frame.get("decrypted") and frame.get("decrypt_confidence"):
        conf = frame.get("decrypt_confidence", 0)
        if conf < DECRYPT_CONFIDENCE_FLOOR:
            return (PENALTY["weak_decrypt"],
                    f"Low decrypt confidence: {conf}")
    return _PASS


# Application order is part of the contract (factors commute but the
# issue list's order is compared verbatim by the conformance A/B).
FRAME_RULES: Tuple[Rule, ...] = (
    _rule_crc,
    _rule_frame_type,
    _rule_network,
    _rule_cipher,
    _rule_decrypt,
)


class TetraSignalValidator:
    """Gates decoded frames on CRC / structure / network-ID plausibility."""

    VALID_MCC_MIN = 200
    VALID_MCC_MAX = 799

    EUROPEAN_TETRA_MCCS = {
        202, 204, 206, 208, 212, 213, 214, 216, 218, 219, 220, 222, 225, 226,
        228, 230, 231, 232, 234, 235, 238, 240, 242, 244, 246, 247, 248, 250,
        255, 257, 259, 260, 262, 266, 268, 270, 272, 274, 276, 278, 280, 282,
        283, 284, 286, 288, 290, 292, 293, 294, 295, 297,
    }

    POLAND_MNC = {
        1: "Plus/Polkomtel",
        2: "T-Mobile Poland",
        3: "Orange Poland",
        6: "Play",
        98: "Mission Critical",
        99: "Emergency Services",
    }

    def __init__(self, expected_country_mcc=None):
        self.expected_mcc = expected_country_mcc
        self.detected_networks = set()
        self.frame_count = 0
        self.valid_frame_count = 0

    def validate_mcc_mnc(self, mcc, mnc):
        """-> (is_valid, confidence, reason)  (validator.py:49-88)."""
        if mcc is None:
            return (False, 0.0, "No MCC present")
        if mcc < self.VALID_MCC_MIN or mcc > self.VALID_MCC_MAX:
            return (False, 0.0,
                    f"MCC {mcc} out of valid range "
                    f"({self.VALID_MCC_MIN}-{self.VALID_MCC_MAX})")
        # plausibility ladder: later rungs override earlier ones
        confidence = MCC_CONFIDENCE["base"]
        if mcc in self.EUROPEAN_TETRA_MCCS:
            confidence = MCC_CONFIDENCE["european"]
        if self.expected_mcc and mcc == self.expected_mcc:
            confidence = MCC_CONFIDENCE["expected"]
            reason = f"MCC {mcc} matches expected location"
        elif self.expected_mcc and mcc != self.expected_mcc:
            confidence = MCC_CONFIDENCE["mismatch"]
            reason = f"MCC {mcc} differs from expected {self.expected_mcc}"
        else:
            reason = f"MCC {mcc} is valid"
        if mnc is not None and mnc > 999:
            confidence *= PENALTY["mnc_implausible"]
            reason += f" but MNC {mnc} seems high"
        self.detected_networks.add((mcc, mnc))
        return (True, confidence, reason)

    def validate_frame(self, frame):
        """-> (is_valid, confidence, issues): fold FRAME_RULES over the
        frame (validator.py:90-161)."""
        self.frame_count += 1
        confidence = 1.0
        issues = []
        for rule in FRAME_RULES:
            factor, issue = rule(frame, self)
            confidence *= factor
            if issue is not None:
                issues.append(issue)
        is_valid = (confidence >= ACCEPT_CONFIDENCE
                    and len(issues) <= ACCEPT_MAX_ISSUES)
        if is_valid:
            self.valid_frame_count += 1
        return (is_valid, confidence, issues)

    def get_statistics(self):
        valid_rate = self.valid_frame_count / max(1, self.frame_count)
        return {
            "total_frames": self.frame_count,
            "valid_frames": self.valid_frame_count,
            "valid_rate": valid_rate * 100,
            "detected_networks": list(self.detected_networks),
            "is_likely_tetra": valid_rate > 0.3,
        }

    def format_network_info(self, mcc, mnc):
        if mcc == 260:
            operator = self.POLAND_MNC.get(mnc, f"Unknown (MNC {mnc})")
            return f"\U0001F1F5\U0001F1F1 Poland MCC 260 - {operator}"
        return f"MCC {mcc} MNC {mnc}"
