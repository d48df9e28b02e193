"""Live voice playback + continuous WAV capture.

Host-side equivalent of the reference GUI's audio-out path
(tetraear/ui/modern.py:4137-4282: sounddevice playback at 8 kHz plus a
continuous per-run WAV whose file is deleted if it ends up silent).  A
host may have no sound hardware and no ``sounddevice`` wheel (a card's
server usually has neither), so the sink degrades gracefully through
three backends:

    sounddevice (if importable)  ->  aplay/paplay subprocess  ->  WAV only

The WAV recorder always runs when a directory is given, matching the
reference's "record everything, delete silence" behavior.
"""

from __future__ import annotations

import logging
import os
import shutil
import subprocess
import time
import wave
from pathlib import Path
from typing import Optional

import numpy as np

logger = logging.getLogger(__name__)

SILENCE_RMS = 1e-4        # below this the run's WAV is deleted (ref :4236)


def _detect_backend() -> str:
    try:
        import sounddevice  # noqa: F401
        return "sounddevice"
    except Exception:
        pass
    for exe in ("aplay", "paplay"):
        if shutil.which(exe):
            return exe
    return "wav-only"


class AudioSink:
    """Plays decoded 8 kHz float32 PCM and/or records it to a WAV.

    play() never raises: playback failures downgrade the backend and the
    audio still lands in the WAV (the reference treats playback as
    best-effort too, modern.py:4168-4175).
    """

    def __init__(self, sample_rate: int = 8000,
                 record_dir: Optional[str] = None,
                 backend: Optional[str] = None):
        self.sample_rate = int(sample_rate)
        self.backend = backend or _detect_backend()
        self._wav = None
        self._wav_path: Optional[Path] = None
        self._peak_rms = 0.0
        self._sd_stream = None
        self._pipe: Optional[subprocess.Popen] = None
        if record_dir:
            Path(record_dir).mkdir(parents=True, exist_ok=True)
            self._wav_path = (Path(record_dir) /
                              f"voice_{time.strftime('%Y%m%d_%H%M%S')}.wav")
            self._wav = wave.open(str(self._wav_path), "wb")
            self._wav.setnchannels(1)
            self._wav.setsampwidth(2)
            self._wav.setframerate(self.sample_rate)
        logger.info("AudioSink backend=%s record=%s", self.backend,
                    self._wav_path)

    # ------------------------------------------------------------------
    def play(self, pcm: np.ndarray) -> None:
        """Queue one block of float32 PCM in [-1, 1]."""
        pcm = np.asarray(pcm, np.float32).reshape(-1)
        if pcm.size == 0:
            return
        self._peak_rms = max(self._peak_rms,
                             float(np.sqrt(np.mean(pcm ** 2))))
        i16 = np.clip(pcm * 32767.0, -32768, 32767).astype("<i2")
        if self._wav is not None:
            try:
                self._wav.writeframes(i16.tobytes())
            except Exception:
                logger.debug("WAV write failed", exc_info=True)
        if self.backend == "sounddevice":
            try:
                import sounddevice as sd
                if self._sd_stream is None:
                    self._sd_stream = sd.OutputStream(
                        samplerate=self.sample_rate, channels=1,
                        dtype="float32")
                    self._sd_stream.start()
                self._sd_stream.write(pcm.reshape(-1, 1))
                return
            except Exception:
                logger.warning("sounddevice playback failed; downgrading")
                self.backend = _detect_backend() \
                    if _detect_backend() != "sounddevice" else "wav-only"
        if self.backend in ("aplay", "paplay"):
            # ONE persistent player process with a raw-PCM stdin pipe —
            # per-block subprocess.run would block the capture loop for
            # the full playback duration of every block (the reference
            # keeps a persistent output stream too, modern.py:4161)
            try:
                if self._pipe is None or self._pipe.poll() is not None:
                    self._pipe = subprocess.Popen(
                        [self.backend, "-q", "-f", "S16_LE", "-r",
                         str(self.sample_rate), "-c", "1", "-t", "raw",
                         "-"],
                        stdin=subprocess.PIPE,
                        stdout=subprocess.DEVNULL,
                        stderr=subprocess.DEVNULL)
                self._pipe.stdin.write(i16.tobytes())
                self._pipe.stdin.flush()
            except Exception:
                logger.warning("%s playback failed; WAV-only from here",
                               self.backend)
                self._pipe = None
                self.backend = "wav-only"

    # ------------------------------------------------------------------
    def close(self) -> Optional[Path]:
        """Finalize; silent recordings are deleted (reference behavior).
        Returns the kept WAV path, if any."""
        if self._sd_stream is not None:
            try:
                self._sd_stream.stop()
                self._sd_stream.close()
            except Exception:
                pass
            self._sd_stream = None
        if self._pipe is not None:
            try:
                self._pipe.stdin.close()
                self._pipe.wait(timeout=5)
            except Exception:
                try:
                    self._pipe.kill()
                except Exception:
                    pass
            self._pipe = None
        if self._wav is not None:
            try:
                self._wav.close()
            except Exception:
                pass
            self._wav = None
            if self._wav_path is not None:
                if self._peak_rms < SILENCE_RMS:
                    try:
                        os.unlink(self._wav_path)
                        logger.info("Deleted silent recording %s",
                                    self._wav_path.name)
                    except OSError:
                        pass
                    self._wav_path = None
                return self._wav_path
        return None
