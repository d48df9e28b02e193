"""Offline frame-log queries: the headless equivalent of the reference
GUI's dropdown filters (modern.py Calls/Groups/Users/Message-Types
dropdowns and the live statistics panel).

Operates on the frames-JSONL conformance artifact written by
`decode`/`listen` (io/recorder.JsonlFrameRecorder) — the same log the
reference's offline tools re-analyze (SURVEY.md §5.4)."""

from __future__ import annotations

import json
from collections import Counter
from dataclasses import dataclass, field
from pathlib import Path
from typing import Iterable, Iterator, Optional


@dataclass
class FrameFilter:
    """Criteria mirroring the GUI dropdowns; None/empty = no constraint."""
    types: tuple = ()             # type_name values (case-insensitive)
    group: Optional[int] = None   # call_metadata.talkgroup_id
    user: Optional[int] = None    # source_ssi OR dest_ssi
    call_type: Optional[str] = None
    timeslot: Optional[int] = None
    encrypted: Optional[bool] = None
    sds_only: bool = False
    # normalized once here, not per frame: matches() runs on every line
    # of a potentially huge continuous-capture log
    _types_lc: frozenset = field(init=False, repr=False, compare=False)
    _call_type_lc: Optional[str] = field(init=False, repr=False,
                                         compare=False)

    def __post_init__(self):
        self._types_lc = frozenset(str(t).lower() for t in self.types)
        self._call_type_lc = (None if self.call_type is None
                              else str(self.call_type).lower())

    def matches(self, frame: dict) -> bool:
        meta = frame.get("call_metadata") or {}
        if self._types_lc:
            if str(frame.get("type_name", "")).lower() not in self._types_lc:
                return False
        if self.group is not None and meta.get("talkgroup_id") != self.group:
            return False
        if self.user is not None and self.user not in (
                meta.get("source_ssi"), meta.get("dest_ssi")):
            return False
        if self._call_type_lc is not None:
            if str(meta.get("call_type", "")).lower() != self._call_type_lc:
                return False
        if self.timeslot is not None \
                and frame.get("timeslot") != self.timeslot:
            return False
        if self.encrypted is not None \
                and bool(frame.get("encrypted")) != self.encrypted:
            return False
        if self.sds_only and not frame.get("sds_message"):
            return False
        return True


def read_frames(path) -> Iterator[dict]:
    """Yield frame dicts from a JSONL log, skipping malformed lines and
    non-frame header records (golden fixtures start with a ``__meta__``
    line — see tests/conformance/test_golden_fixtures.py)."""
    with Path(path).open(encoding="utf-8") as fp:
        for line in fp:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            if not isinstance(rec, dict) or "__meta__" in rec:
                continue
            yield rec


def filter_frames(frames: Iterable[dict], flt: FrameFilter) -> Iterator[dict]:
    return (f for f in frames if flt.matches(f))


@dataclass
class FrameStats:
    """The GUI statistics panel's counters, computed offline."""
    total: int = 0
    crc_pass: int = 0
    encrypted: int = 0
    decrypted: int = 0
    sds: int = 0
    by_type: Counter = field(default_factory=Counter)
    groups: Counter = field(default_factory=Counter)
    users: Counter = field(default_factory=Counter)
    call_types: Counter = field(default_factory=Counter)

    def add(self, frame: dict) -> None:
        self.total += 1
        if frame.get("burst_crc", frame.get("crc_ok")):
            self.crc_pass += 1
        if frame.get("encrypted"):
            self.encrypted += 1
        if frame.get("decrypted"):
            self.decrypted += 1
        if frame.get("sds_message"):
            self.sds += 1
        self.by_type[str(frame.get("type_name", "?"))] += 1
        meta = frame.get("call_metadata") or {}
        if meta.get("talkgroup_id") is not None:
            self.groups[meta["talkgroup_id"]] += 1
        for k in ("source_ssi", "dest_ssi"):
            if meta.get(k) is not None:
                self.users[meta[k]] += 1
        if meta.get("call_type"):
            self.call_types[str(meta["call_type"])] += 1


def frames_stats(frames: Iterable[dict]) -> FrameStats:
    st = FrameStats()
    for f in frames:
        st.add(f)
    return st


def format_frame_line(frame: dict) -> str:
    """One-line human rendering (number/type/slot + the interesting bits)."""
    meta = frame.get("call_metadata") or {}
    parts = [f"#{frame.get('number', '?')}",
             str(frame.get("type_name", "?")),
             f"TS{frame.get('timeslot', '?')}"]
    if frame.get("encrypted"):
        alg = frame.get("encryption_algorithm")
        parts.append(f"ENC[{alg}]" if alg else "ENC")
        if frame.get("decrypted"):
            parts.append("DECRYPTED")
    if meta.get("talkgroup_id") is not None:
        parts.append(f"grp={meta['talkgroup_id']}")
    if meta.get("source_ssi") is not None:
        parts.append(f"src={meta['source_ssi']}")
    if meta.get("dest_ssi") is not None:
        parts.append(f"dst={meta['dest_ssi']}")
    if meta.get("call_type"):
        parts.append(str(meta["call_type"]))
    sds = frame.get("sds_message")
    if sds:
        text = sds.get("text") if isinstance(sds, dict) else str(sds)
        if text:
            parts.append(repr(text))
    return " ".join(parts)
