"""Session aggregation: the compute behind the reference GUI's tables and
message reassembly (ui/modern.py:4284-4560 reassemble_sds_message,
:4562-4746 update_tables — frames/calls/groups/users views).

Headless: feed decoded frames in; read aggregate tables out (and print a
summary for the CLI)."""

from __future__ import annotations

import logging
from collections import OrderedDict
from typing import Dict, List, Optional

logger = logging.getLogger(__name__)


def reassemble_sds_message(frame: dict, fragment_store: Optional[dict] = None
                           ) -> Optional[str]:
    """Message-level SDS reassembly (modern.py:4284-4360).

    Returns the frame's parsed text when present; otherwise buffers
    explicit fragment metadata (address_source/fragment_id/is_last_fragment
    keys) and reassembles on the last fragment."""
    if frame.get("sds_message"):
        return frame["sds_message"]
    if frame.get("decoded_text"):
        return frame["decoded_text"]
    if frame.get("encrypted") and not frame.get("decrypted"):
        return None

    addr_src = frame.get("address_source")
    addr_dst = frame.get("address_destination")
    frag_id = frame.get("fragment_id")
    is_last = frame.get("is_last_fragment", False)
    if not (addr_src and frag_id is not None) or fragment_store is None:
        return None

    key = f"{addr_src}_{addr_dst}_{frag_id}"
    fragment_store.setdefault(key, []).append(frame)
    if is_last and len(fragment_store[key]) > 1:
        fragments = sorted(fragment_store.pop(key),
                           key=lambda f: f.get("fragment_index", 0))
        combined = b""
        for frag in fragments:
            if "decrypted_bytes" in frag:
                try:
                    combined += bytes.fromhex(frag["decrypted_bytes"])
                    continue
                except Exception:
                    pass
            data = (frag.get("mac_pdu") or {}).get("data")
            if isinstance(data, (bytes, bytearray)):
                combined += bytes(data)
            elif isinstance(data, str):
                try:
                    combined += bytes.fromhex(data.replace(" ", ""))
                except Exception:
                    pass
        if combined:
            from tetraear_tpu_torch.protocol.sds import parse_sds_data
            return parse_sds_data(combined)
    return None


class SessionAggregator:
    """Accumulates per-session views: frames, calls, talkgroups, users."""

    MAX_FRAMES = 1000

    def __init__(self, expected_mcc: Optional[int] = None):
        from tetraear_tpu_torch.core.validator import TetraSignalValidator
        self.validator = TetraSignalValidator(expected_country_mcc=expected_mcc)
        self.frames: List[dict] = []
        self.calls: "OrderedDict[object, dict]" = OrderedDict()
        self.groups: Dict[int, dict] = {}
        self.users: Dict[int, dict] = {}
        self.sds_fragments: dict = {}
        self.frame_count = 0
        self.decrypted_count = 0
        self.messages: List[str] = []

    def on_frame(self, frame: dict) -> dict:
        """Process one decoded frame; returns a row summary dict."""
        self.frame_count += 1
        if frame.get("decrypted"):
            self.decrypted_count += 1

        valid, confidence, issues = self.validator.validate_frame(frame)
        text = reassemble_sds_message(frame, self.sds_fragments)
        if text:
            self.messages.append(text)

        meta = frame.get("call_metadata") or {}
        tg = meta.get("talkgroup_id")
        if tg:
            g = self.groups.setdefault(tg, {"talkgroup": tg, "frames": 0,
                                            "last_type": None})
            g["frames"] += 1
            g["last_type"] = frame.get("type_name")
            call_key = (tg, meta.get("call_identifier"))
            call = self.calls.setdefault(call_key, {
                "talkgroup": tg, "call_id": meta.get("call_identifier"),
                "type": meta.get("call_type"), "frames": 0,
                "encrypted": bool(meta.get("encryption")),
            })
            call["frames"] += 1
        for ssi_key in ("source_ssi", "dest_ssi"):
            ssi = meta.get(ssi_key)
            if ssi:
                u = self.users.setdefault(ssi, {"ssi": ssi, "frames": 0,
                                                "talkgroups": set()})
                u["frames"] += 1
                if tg:
                    u["talkgroups"].add(tg)

        mcc = meta.get("mcc") or (frame.get("additional_info") or {}).get("mcc")
        country = ""
        if mcc:
            from tetraear_tpu_torch.core.mcc_mnc import get_country_from_mcc
            country = get_country_from_mcc(str(mcc))

        row = {
            "number": frame.get("number"),
            "type_name": frame.get("type_name"),
            "encrypted": frame.get("encrypted"),
            "decrypted": frame.get("decrypted", False),
            "crc": frame.get("burst_crc"),
            "text": text,
            "valid": valid,
            "confidence": confidence,
            "issues": issues,
            "country": country,
        }
        self.frames.append(row)
        if len(self.frames) > self.MAX_FRAMES:
            self.frames = self.frames[-self.MAX_FRAMES:]
        return row

    def summary(self) -> str:
        stats = self.validator.get_statistics()
        lines = [
            f"Frames: {self.frame_count} "
            f"(decrypted {self.decrypted_count}, "
            f"valid {stats['valid_frames']}/{stats['total_frames']})",
            f"Talkgroups: {len(self.groups)}  Calls: {len(self.calls)}  "
            f"Users: {len(self.users)}  Messages: {len(self.messages)}",
        ]
        if stats["detected_networks"]:
            nets = ", ".join(f"MCC {m}/MNC {n}"
                             for m, n in stats["detected_networks"])
            lines.append(f"Networks: {nets}")
        for tg, g in sorted(self.groups.items())[:10]:
            lines.append(f"  TG {tg}: {g['frames']} frames "
                         f"(last {g['last_type']})")
        return "\n".join(lines)
