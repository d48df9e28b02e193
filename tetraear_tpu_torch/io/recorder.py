"""Recorders: frames-JSONL (the conformance artifact), raw codec-block .bin,
and voice/raw WAV files.

The JSONL frame log is the de-facto resume/analysis format of the reference
(SURVEY.md §5.4): offline tools re-analyze it (bruteforce_keys.py,
analyze_text.py).  The sanitizer matches continuous_capture.py:64-80.
"""

from __future__ import annotations

import json
import logging
from datetime import datetime
from pathlib import Path
from typing import IO, Optional

import numpy as np

logger = logging.getLogger(__name__)
frames_logger = logging.getLogger("tetraear_tpu_torch.frames")


def sanitize_frame(value):
    """numpy/bytes -> JSON-serializable (continuous_capture.py:64-77)."""
    if isinstance(value, np.ndarray):
        return value.tolist()
    if isinstance(value, (np.bool_,)):
        return bool(value)
    if isinstance(value, np.integer):
        return int(value)
    if isinstance(value, np.floating):
        return float(value)
    if isinstance(value, (bytes, bytearray)):
        return bytes(value).hex()
    if isinstance(value, dict):
        return {k: sanitize_frame(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [sanitize_frame(v) for v in value]
    return value


class JsonlFrameRecorder:
    """Appends one JSON line per decoded frame."""

    def __init__(self, path: str | Path, include_bits: bool = True):
        self.path = Path(path)
        self.include_bits = include_bits
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._fp: Optional[IO] = None
        self.count = 0

    def __enter__(self):
        self._fp = self.path.open("w", encoding="utf-8")
        return self

    def __exit__(self, *exc):
        self.close()

    def write(self, frame: dict) -> None:
        if self._fp is None:
            self._fp = self.path.open("w", encoding="utf-8")
        record = dict(frame)
        if not self.include_bits:
            record.pop("bits", None)
        serializable = {k: sanitize_frame(v) for k, v in record.items()}
        self._fp.write(json.dumps(serializable, ensure_ascii=False) + "\n")
        self._fp.flush()
        self.count += 1

    def close(self) -> None:
        if self._fp is not None:
            self._fp.close()
            self._fp = None


def read_jsonl_frames(path: str | Path):
    """Iterate frames from a JSONL log (offline-tool input format)."""
    with Path(path).open("r", encoding="utf-8") as fp:
        for line in fp:
            line = line.strip()
            if not line:
                continue
            try:
                yield json.loads(line)
            except json.JSONDecodeError:
                continue


class RawFrameRecorder:
    """Appends 1380-byte codec blocks to a .bin file
    (ui/modern.py:2204-2222 contract)."""

    def __init__(self, records_dir: str | Path, frequency_hz: float):
        records_dir = Path(records_dir)
        records_dir.mkdir(parents=True, exist_ok=True)
        ts = datetime.now().strftime("%Y%m%d_%H%M%S")
        self.path = records_dir / (
            f"tetra_frames_{frequency_hz / 1e6:.3f}MHz_{ts}.bin")
        self.count = 0

    def append(self, codec_block: bytes) -> None:
        with self.path.open("ab") as f:
            f.write(codec_block)
        self.count += 1


class WavRecorder:
    """Streaming 16-bit mono WAV writer (voice 8 kHz / raw FM 48 kHz)."""

    def __init__(self, path: str | Path, sample_rate: int):
        import wave
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._wf = wave.open(str(self.path), "wb")
        self._wf.setnchannels(1)
        self._wf.setsampwidth(2)
        self._wf.setframerate(sample_rate)
        self.samples_written = 0

    def write(self, audio: np.ndarray) -> None:
        audio_i16 = np.clip(np.asarray(audio) * 32767.0, -32768, 32767
                            ).astype(np.int16)
        self._wf.writeframes(audio_i16.tobytes())
        self.samples_written += audio_i16.size

    def close(self, delete_if_silent: bool = False) -> None:
        self._wf.close()
        if delete_if_silent and self.samples_written == 0:
            try:
                self.path.unlink(missing_ok=True)
            except Exception:
                pass
