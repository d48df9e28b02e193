"""Audio export helpers (behavioral parity with tetraear/audio/export.py)."""

from __future__ import annotations

import logging
import shutil
import subprocess
import wave
from pathlib import Path

import numpy as np

logger = logging.getLogger(__name__)


def write_wav(path, audio: np.ndarray, sample_rate: int = 8000) -> None:
    """float32 [-1, 1] -> 16-bit mono WAV."""
    audio_i16 = np.clip(np.asarray(audio) * 32767.0, -32768, 32767
                        ).astype(np.int16)
    with wave.open(str(path), "wb") as wf:
        wf.setnchannels(1)
        wf.setsampwidth(2)
        wf.setframerate(sample_rate)
        wf.writeframes(audio_i16.tobytes())


def wav_to_mp3(wav_path, mp3_path=None, bitrate: str = "128k") -> bool:
    """ffmpeg WAV -> MP3 (export.py:19-67); returns False if ffmpeg absent."""
    wav_path = Path(wav_path)
    if mp3_path is None:
        mp3_path = wav_path.with_suffix(".mp3")
    if shutil.which("ffmpeg") is None:
        logger.warning("ffmpeg not found; cannot convert %s", wav_path)
        return False
    try:
        result = subprocess.run(
            ["ffmpeg", "-y", "-i", str(wav_path),
             "-codec:a", "libmp3lame", "-b:a", bitrate, str(mp3_path)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            check=False, timeout=60)
        ok = result.returncode == 0 and Path(mp3_path).exists()
        if not ok:
            logger.error("ffmpeg failed: %s",
                         result.stderr.decode("utf-8", "ignore")[-400:])
        return ok
    except Exception as e:
        logger.error("wav_to_mp3 failed: %s", e)
        return False
