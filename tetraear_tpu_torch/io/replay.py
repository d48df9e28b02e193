"""IQ file replay sources.

On TPU hosts there is no USB SDR; recorded IQ replay is the primary
ingestion path (BASELINE config 5: "live BladeRF-rate replay").  Sources
expose the same surface as the capture driver (``open/read_samples/
set_frequency/close``) so the scanner, capture loop and CLI are
source-agnostic.

Formats:
  .cf32 / .fc32 / .iq  interleaved float32 I/Q
  .cs16 / .sc16        interleaved int16 I/Q (BladeRF SC16-Q11, /2048)
  .cs8  / .sc8         interleaved int8 I/Q (/127)
  .npy                 complex64/complex128 numpy array
  .json sidecar        {"sample_rate": ..., "center_frequency": ...}
"""

from __future__ import annotations

import json
import logging
import time
from pathlib import Path
from typing import Optional

import numpy as np

logger = logging.getLogger(__name__)


def load_iq(path: str | Path) -> np.ndarray:
    """Load a whole IQ file as complex64."""
    path = Path(path)
    suffix = path.suffix.lower()
    if suffix == ".npy":
        arr = np.load(path)
        return np.asarray(arr, dtype=np.complex64)
    raw = np.fromfile(path, dtype=_dtype_for(suffix))
    if raw.size % 2:
        raw = raw[:-1]
    scale = _scale_for(suffix)
    iq = raw.astype(np.float32).reshape(-1, 2)
    return ((iq[:, 0] + 1j * iq[:, 1]) * scale).astype(np.complex64)


def _dtype_for(suffix: str):
    if suffix in (".cf32", ".fc32", ".iq", ".f32"):
        return np.float32
    if suffix in (".cs16", ".sc16", ".s16"):
        return np.int16
    if suffix in (".cs8", ".sc8", ".s8"):
        return np.int8
    raise ValueError(f"Unknown IQ file format: {suffix}")


def _scale_for(suffix: str) -> float:
    if suffix in (".cs16", ".sc16", ".s16"):
        return 1.0 / 2048.0     # BladeRF SC16-Q11
    if suffix in (".cs8", ".sc8", ".s8"):
        return 1.0 / 127.0
    return 1.0


def save_iq(path: str | Path, samples: np.ndarray,
            sample_rate: Optional[float] = None,
            center_frequency: Optional[float] = None) -> None:
    """Write complex64 IQ (format from extension) + JSON sidecar."""
    path = Path(path)
    suffix = path.suffix.lower()
    samples = np.asarray(samples, dtype=np.complex64)
    if suffix == ".npy":
        np.save(path, samples)
    else:
        inter = np.empty(samples.size * 2, dtype=np.float32)
        inter[0::2] = samples.real
        inter[1::2] = samples.imag
        if _dtype_for(suffix) == np.float32:
            inter.astype(np.float32).tofile(path)
        elif _dtype_for(suffix) == np.int16:
            np.clip(inter / _scale_for(suffix), -32768, 32767
                    ).astype(np.int16).tofile(path)
        else:
            np.clip(inter / _scale_for(suffix), -128, 127
                    ).astype(np.int8).tofile(path)
    if sample_rate is not None or center_frequency is not None:
        meta = {}
        if sample_rate is not None:
            meta["sample_rate"] = sample_rate
        if center_frequency is not None:
            meta["center_frequency"] = center_frequency
        path.with_suffix(path.suffix + ".json").write_text(json.dumps(meta))


def read_sidecar(path: str | Path) -> dict:
    side = Path(str(path) + ".json")
    if side.exists():
        try:
            return json.loads(side.read_text())
        except Exception:
            pass
    return {}


class FileReplaySource:
    """Replays a recorded IQ file through the capture interface.

    Matches the surface of BladeRFCapture (capture.py:87-328): ``open()``,
    ``read_samples(n)``, ``set_frequency(f)``, ``close()``, plus
    ``sample_rate``/``frequency`` attributes.  ``realtime`` paces reads at
    the capture rate (for live-rate replay benchmarks); ``loop`` wraps
    around at EOF instead of raising.
    """

    def __init__(self, path: str | Path, sample_rate: Optional[float] = None,
                 frequency: Optional[float] = None, loop: bool = False,
                 realtime: bool = False):
        self.path = Path(path)
        meta = read_sidecar(self.path)
        self.sample_rate = sample_rate or meta.get("sample_rate", 2.4e6)
        self.frequency = frequency or meta.get("center_frequency", 390.865e6)
        self.loop = loop
        self.realtime = realtime
        self._data: Optional[np.ndarray] = None
        self._pos = 0
        self._last_read_t: Optional[float] = None
        self.sdr = None  # API-parity attribute (capture exposes .sdr)

    def open(self) -> bool:
        try:
            self._data = load_iq(self.path)
        except Exception as e:
            logger.error("Failed to load IQ file %s: %s", self.path, e)
            return False
        self._pos = 0
        logger.info("Replay source: %s (%d samples @ %.0f Hz)",
                    self.path.name, len(self._data), self.sample_rate)
        return True

    def read_samples(self, num_samples: int) -> np.ndarray:
        if self._data is None:
            raise RuntimeError("Replay source not opened")
        if self.realtime:
            now = time.monotonic()
            if self._last_read_t is not None:
                budget = num_samples / self.sample_rate
                sleep = self._last_read_t + budget - now
                if sleep > 0:
                    time.sleep(sleep)
            self._last_read_t = time.monotonic()
        out = np.empty(0, np.complex64)
        remaining = num_samples
        while remaining > 0:
            chunk = self._data[self._pos:self._pos + remaining]
            out = chunk if out.size == 0 else np.concatenate([out, chunk])
            self._pos += len(chunk)
            remaining -= len(chunk)
            if remaining > 0:
                if not self.loop:
                    break
                self._pos = 0
        return out

    @property
    def exhausted(self) -> bool:
        return (self._data is not None and not self.loop
                and self._pos >= len(self._data))

    def set_frequency(self, frequency: float) -> None:
        """Retune is a no-op on a recording; tracked for scanner parity."""
        self.frequency = frequency

    def close(self) -> None:
        self._data = None


class SyntheticSource:
    """Procedurally generated IQ through the capture interface — used by the
    scanner tests and demo mode.  A set of 'active' carrier frequencies
    produce TETRA-like bursts; elsewhere it yields noise."""

    def __init__(self, active_frequencies=(392.5e6,), sample_rate: float = 2.4e6,
                 frequency: float = 390.0e6, snr_db: float = 20.0, seed: int = 0):
        self.active = list(active_frequencies)
        self.sample_rate = sample_rate
        self.frequency = frequency
        self.snr_db = snr_db
        self._seed = seed
        self.sdr = None

    def open(self) -> bool:
        return True

    def set_frequency(self, frequency: float) -> None:
        self.frequency = frequency

    def read_samples(self, num_samples: int) -> np.ndarray:
        from tetraear_tpu_torch.utils import synth
        rng = np.random.default_rng(self._seed)
        self._seed += 1
        noise_std = 10 ** (-self.snr_db / 20)
        noise = noise_std / np.sqrt(2) * (
            rng.standard_normal(num_samples)
            + 1j * rng.standard_normal(num_samples))
        out = noise.astype(np.complex64)
        for f in self.active:
            offset = f - self.frequency
            if abs(offset) > self.sample_rate / 2:
                continue
            nsym = int(num_samples / (self.sample_rate / 18000.0)) + 2
            syms = rng.integers(0, 4, max(nsym, 2))
            x = synth.synthesize_iq(syms, self.sample_rate,
                                    freq_offset_hz=offset, mapping="pi4")
            out = out + x[:num_samples]
        return out

    def close(self) -> None:
        pass
