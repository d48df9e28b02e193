"""TETRA signal detection (port of `tetraear_tpu.signal.detector`;
behavioral parity with tetraear/signal/scanner.py:24-289).

The probes are the reference's numpy copies; `validate_frames` runs the
port's single-carrier receiver and the dense sync scores of its
`TetraDecoder` on the detector's `device`.

Where the port differs from the reference on purpose: the reference
turns every exception of `validate_frames` into "not TETRA".  Here the
device work (the `SignalProcessor`'s construction, which copies its
taps to the device, `process`, and `TetraDecoder.sync_scores`) runs
outside that catch, so that a failed kernel, a CUDA error or an
out-of-memory ends the scan instead of reading as "no signal"; the
catch keeps guarding the host decode of the frames.
"""

from __future__ import annotations

import logging
from typing import Dict, Tuple

import numpy as np

from tetraear_tpu_torch import constants as C

logger = logging.getLogger(__name__)


class TetraSignalDetector:
    """Detects TETRA signals in captured samples."""

    def __init__(self, sample_rate: float = 2.4e6, noise_floor: float = -45,
                 bottom_threshold: float = -85, *, device):
        self.sample_rate = sample_rate
        self.device = device
        self.symbol_rate = C.SYMBOL_RATE_HZ
        self.channel_bandwidth = C.CHANNEL_BANDWIDTH_HZ
        self.noise_floor = noise_floor
        self.bottom_threshold = bottom_threshold

    def calculate_power(self, samples: np.ndarray) -> float:
        """Mean power in dB (scanner.py:42-55)."""
        samples = np.asarray(samples)
        if samples.size == 0:
            return float(self.bottom_threshold)
        power = np.mean(np.abs(samples) ** 2)
        return float(10 * np.log10(power + 1e-10))

    def detect_tetra_modulation(self, samples: np.ndarray) -> Tuple[bool, float]:
        """Phase-difference clustering at pi/4 multiples (scanner.py:57-96),
        vectorized: confidence = fraction of diffs within pi/8 of a
        multiple of pi/4 (which is every phase's distance to the nearest
        multiple of pi/4, so the tolerance test reduces to a modular
        distance)."""
        samples = np.asarray(samples)
        if len(samples) < 1000:
            return False, 0.0
        samples = samples / (np.abs(samples).max() + 1e-10)
        phase_diffs = np.diff(np.angle(samples))
        phase_diffs = (phase_diffs + np.pi) % (2 * np.pi) - np.pi
        # the reference's expected-phase list omits +pi and measures *linear*
        # distance, so diffs near +pi do NOT match — keep that behavior
        expected = np.array([-np.pi, -3 * np.pi / 4, -np.pi / 2, -np.pi / 4,
                             0.0, np.pi / 4, np.pi / 2, 3 * np.pi / 4])
        dist = np.min(np.abs(phase_diffs[:, None] - expected[None, :]), axis=1)
        confidence = float(np.mean(dist < np.pi / 8))
        return confidence > C.SCAN_MOD_CONFIDENCE, confidence

    def detect_sync_pattern(self, samples: np.ndarray) -> Tuple[bool, float]:
        """Coarse 31-bit sync probe on crudely-sliced bits
        (scanner.py:98-147)."""
        samples = np.asarray(samples)
        downsample = max(1, int(self.sample_rate / self.symbol_rate / 10))
        symbols = samples[::downsample]
        if len(symbols) < 100:
            return False, 0.0
        phase_diffs = np.diff(np.angle(symbols))
        phase_diffs = (phase_diffs + np.pi) % (2 * np.pi) - np.pi
        quantized = np.round(phase_diffs / (np.pi / 4)) * (np.pi / 4)
        bits = (np.abs(quantized) < np.pi / 8).astype(np.uint8)
        pattern = C.SCANNER_SYNC_PATTERN_31
        if len(bits) < len(pattern):
            return False, 0.0
        # dense correlation via the device matched filter shape: +/-1 conv
        n = len(bits) - len(pattern)
        if n <= 0:
            return False, 0.0
        x = bits.astype(np.float32) * 2 - 1
        p = pattern.astype(np.float32) * 2 - 1
        corr = np.correlate(x, p, mode="valid")
        matches = (len(pattern) + corr) / 2.0 / len(pattern)
        # reference iterates range(len(bits)-31) — drops the last window
        max_corr = float(matches[:n].max()) if n > 0 else 0.0
        return max_corr > C.SCAN_SYNC_CORRELATION, max_corr

    def validate_frames(self, samples: np.ndarray) -> Tuple[bool, float]:
        """Full-pipeline validation (scanner.py:149-202): demod + decode and
        check the CRC pass rate.  A new processor and decoder per call, as
        in the reference."""
        samples = np.asarray(samples)
        if len(samples) < 10000:
            return False, 0.0
        from tetraear_tpu_torch.core.decoder import TetraDecoder
        from tetraear_tpu_torch.models.receiver import SignalProcessor
        processor = SignalProcessor(sample_rate=self.sample_rate,
                                    device=self.device)
        demodulated = processor.process(samples)
        if len(demodulated) < C.SYMBOLS_PER_SLOT:
            return False, 0.0
        decoder = TetraDecoder(auto_decrypt=False, device=self.device)
        scored = decoder.sync_scores(demodulated)
        try:
            frames = decoder.decode_scored(scored)
            if len(frames) == 0:
                return False, 0.0
            crc_pass = 0.0
            for frame in frames:
                if frame.get("burst_crc") is True:
                    crc_pass += 1
                elif frame.get("burst_crc") is False:
                    pass
                elif "type" in frame and "number" in frame:
                    crc_pass += 0.5
            crc_rate = crc_pass / max(len(frames), 1)
            return (len(frames) >= 2 and crc_rate > 0.5), crc_rate
        except Exception as e:
            logger.debug("Frame validation error: %s", e)
            return False, 0.0

    def check_power_stability(self, samples: np.ndarray,
                              num_windows: int = 5) -> bool:
        """Power std < 10 dB over windows (scanner.py:204-231)."""
        samples = np.asarray(samples)
        if len(samples) < num_windows * 1000:
            return False
        window_size = len(samples) // num_windows
        powers = [self.calculate_power(
            samples[i * window_size:(i + 1) * window_size])
            for i in range(num_windows)]
        if len(powers) > 1:
            return bool(np.std(powers) < 10.0)
        return True

    def analyze_signal(self, samples: np.ndarray) -> Dict:
        """Combined gate: modulation AND sync AND stability, with full frame
        validation as an override (scanner.py:233-289)."""
        samples = np.asarray(samples)
        power = self.calculate_power(samples)
        is_tetra_mod, mod_confidence = self.detect_tetra_modulation(samples)
        has_sync, sync_correlation = self.detect_sync_pattern(samples)
        basic_tetra_match = is_tetra_mod and has_sync
        frames_valid, crc_rate = self.validate_frames(samples)
        power_stable = self.check_power_stability(samples)

        if has_sync and is_tetra_mod:
            confidence = (mod_confidence * 0.4 + sync_correlation * 0.4
                          + crc_rate * 0.2)
        elif has_sync:
            confidence = sync_correlation * 0.6
        elif is_tetra_mod:
            confidence = mod_confidence * 0.5
        else:
            confidence = 0.0

        is_tetra = basic_tetra_match and power_stable
        if frames_valid:
            is_tetra = True
            confidence = max(confidence, 0.7)

        return {
            "power_db": power,
            "is_tetra": is_tetra,
            "confidence": confidence,
            "modulation_confidence": mod_confidence,
            "sync_detected": has_sync,
            "sync_correlation": sync_correlation,
            "frames_validated": frames_valid,
            "crc_pass_rate": crc_rate,
            "power_stable": power_stable,
            "signal_present": power > self.bottom_threshold,
        }
