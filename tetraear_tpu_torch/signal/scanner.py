"""Frequency scanner (port of `tetraear_tpu.signal.scanner`; behavioral
parity with tetraear/signal/scanner.py:292-555).

Source-agnostic: works with BladeRFCapture, FileReplaySource, or
SyntheticSource (anything exposing set_frequency/read_samples).  Every
probe runs on the scanner's `device`: the detector's frame validation,
and in `scan_wideband` the spectrum frames and the validation of the hot
channels through the staged multicarrier frontend, whose channelizer is
K5 (`ops.kernels.fused_channelize`) on a CUDA device.

Where the port differs from the reference on purpose: the reference's
`scan_frequency` turns every exception into a -100 dB "no signal"
result.  Here only the retune sits in that catch (reading keeps its own
catch, as in the reference); the analysis, which runs on the device,
does not, so that a failed kernel, a CUDA error or an out-of-memory
ends the scan instead of reading as an empty band.
"""

from __future__ import annotations

import logging
import time
from typing import Dict, List

import numpy as np
import torch

from tetraear_tpu_torch.signal.detector import TetraSignalDetector

logger = logging.getLogger(__name__)


class FrequencyScanner:
    """Scans frequency ranges to find TETRA signals."""

    POLAND_RANGES = [
        (390.0, 395.0),   # primary (includes 392.5 MHz)
        (380.0, 385.0),   # emergency services
        (410.0, 430.0),   # civilian
    ]
    CHANNEL_SPACING = 25.0  # kHz

    def __init__(self, rtl_capture, sample_rate: float = 2.4e6,
                 scan_step: float = 25e3, noise_floor: float = -45,
                 bottom_threshold: float = -85, settle_s: float = 0.05, *,
                 device):
        self.capture = rtl_capture
        self.sample_rate = sample_rate
        self.scan_step = scan_step
        self.noise_floor = noise_floor
        self.bottom_threshold = bottom_threshold
        self.settle_s = settle_s
        self.device = torch.device(device)
        self.detector = TetraSignalDetector(
            sample_rate, noise_floor=noise_floor,
            bottom_threshold=bottom_threshold, device=self.device)
        self.found_channels: List[Dict] = []

    def scan_frequency(self, frequency: float, dwell_time: float = 0.5) -> Dict:
        """Single-frequency probe (scanner.py:325-381)."""
        try:
            if hasattr(self.capture, "sdr") and self.capture.sdr:
                self.capture.sdr.center_freq = frequency
            elif hasattr(self.capture, "set_frequency"):
                self.capture.set_frequency(frequency)
            if self.settle_s:
                time.sleep(self.settle_s)    # PLL settle
        except Exception as e:
            logger.debug("Error scanning %.3f MHz: %s", frequency / 1e6, e)
            return {
                "frequency": frequency,
                "frequency_mhz": frequency / 1e6,
                "power_db": -100,
                "is_tetra": False,
                "confidence": 0.0,
                "signal_present": False,
                "error": str(e),
            }
        num_samples = min(int(self.sample_rate * dwell_time), 256 * 1024)
        try:
            samples = self.capture.read_samples(num_samples)
        except Exception as e:
            logger.debug("Error reading samples at %.3f MHz: %s",
                         frequency / 1e6, e)
            samples = np.array([], dtype=complex)
        if len(samples) > 100:
            analysis = self.detector.analyze_signal(samples)
        else:
            analysis = {
                "power_db": -100, "is_tetra": False,
                "confidence": 0.0, "signal_present": False,
            }
        analysis["frequency"] = frequency
        analysis["frequency_mhz"] = frequency / 1e6
        return analysis

    def scan_range(self, start_freq: float, end_freq: float,
                   min_power: float = -70,
                   min_confidence: float = 0.4) -> List[Dict]:
        """Step scan (scanner.py:383-445): requires TETRA match, power,
        confidence, sync AND stability."""
        logger.info("Scanning range: %.3f - %.3f MHz",
                    start_freq / 1e6, end_freq / 1e6)
        found = []
        num_steps = int((end_freq - start_freq) / self.scan_step)
        for step in range(num_steps + 1):
            freq = start_freq + step * self.scan_step
            if freq > end_freq:
                break
            result = self.scan_frequency(freq, dwell_time=0.3)
            if (result.get("is_tetra", False)
                    and result.get("power_db", -100) > min_power
                    and result.get("confidence", 0) > min_confidence
                    and result.get("sync_detected", False)
                    and result.get("power_stable", False)):
                found.append(result)
                extra = ""
                if result.get("frames_validated", False):
                    extra = f", CRC: {result.get('crc_pass_rate', 0):.1%}"
                logger.info("Found TETRA signal at %.3f MHz - Power: %.1f dB, "
                            "Confidence: %.2f, Sync: %s%s",
                            freq / 1e6, result["power_db"],
                            result["confidence"],
                            result.get("sync_detected", False), extra)
            if step % 10 == 0 and num_steps:
                logger.debug("Scan progress: %.1f%%", step / num_steps * 100)
        return found

    def scan_around_392_5(self, range_mhz: float = 2.5,
                          min_power: float = -70,
                          min_confidence: float = 0.4) -> List[Dict]:
        """scanner.py:447-477."""
        center = 392.5e6
        found = self.scan_range(center - range_mhz * 1e6 / 2,
                                center + range_mhz * 1e6 / 2,
                                min_power=min_power,
                                min_confidence=min_confidence)
        self.found_channels = found
        logger.info("Scan complete. Found %d TETRA channel(s) around 392.5 MHz",
                    len(found))
        return found

    def scan_poland(self, min_power: float = -70,
                    min_confidence: float = 0.4) -> List[Dict]:
        """scanner.py:479-528: primary 390-395 first, then the other bands."""
        logger.info("Starting scan of Poland TETRA frequency ranges...")
        all_found: List[Dict] = []
        primary = (390.0, 395.0)
        all_found.extend(self.scan_range(primary[0] * 1e6, primary[1] * 1e6,
                                         min_power=min_power,
                                         min_confidence=min_confidence))
        for start_mhz, end_mhz in self.POLAND_RANGES:
            if (start_mhz, end_mhz) == primary:
                continue
            all_found.extend(self.scan_range(start_mhz * 1e6, end_mhz * 1e6,
                                             min_power=min_power,
                                             min_confidence=min_confidence))
        all_found.sort(key=lambda x: x["frequency"])
        self.found_channels = all_found
        logger.info("Scan complete. Found %d TETRA channel(s)", len(all_found))
        return all_found

    def scan_wideband(self, center_freq: float,
                      num_samples: int = 1 << 20,
                      channel_spacing: float = 25e3,
                      min_power: float = -70.0,
                      validate: bool = True) -> List[Dict]:
        """Device-first sweep (BASELINE config 3): ONE wideband capture
        covers sample_rate/channel_spacing channels at once; batched FFT
        frames on the device give per-channel power, and candidate
        channels are deep-validated with the staged multicarrier decode
        (K5 on a CUDA device) — no per-channel retune/settle.

        Returns result dicts shaped like scan_frequency's output."""
        from tetraear_tpu_torch.ops import spectrum as spec_ops

        if hasattr(self.capture, "set_frequency"):
            self.capture.set_frequency(center_freq)
        if self.settle_s:
            time.sleep(self.settle_s)
        samples = self.capture.read_samples(num_samples)
        if len(samples) < 4096:
            return []

        n_fft = 4096
        frames = spec_ops.spectrum_frames_dbfs(
            torch.as_tensor(np.asarray(samples, np.complex64),
                            device=self.device), n_fft)
        avg = frames.cpu().numpy().mean(axis=0)
        freqs = spec_ops.fft_freqs(n_fft, self.sample_rate) + center_freq

        half_span = self.sample_rate / 2 - channel_spacing
        first = int(np.ceil((center_freq - half_span) / channel_spacing))
        results = []
        for k in range(first, int((center_freq + half_span)
                                  // channel_spacing) + 1):
            f = k * channel_spacing
            sel = np.abs(freqs - f) <= channel_spacing / 2
            if not np.any(sel):
                continue
            power_db = float(avg[sel].max())
            entry = {"frequency": f, "frequency_mhz": f / 1e6,
                     "power_db": power_db, "is_tetra": False,
                     "confidence": 0.0, "signal_present":
                     power_db > self.bottom_threshold}
            results.append(entry)

        hot = [r for r in results if r["power_db"] > min_power]
        if validate and hot:
            from tetraear_tpu_torch.models.multicarrier import (
                MulticarrierDecoder, StagedMulticarrierFrontend)
            offsets = np.array([r["frequency"] - center_freq for r in hot],
                               np.float32)
            # the reference frontend's tiling contract, N % 5120 == 0, kept
            # so that the same samples are validated
            usable = (len(samples) // 5120) * 5120
            if usable >= 5120:
                # the reference's default MulticarrierFrontend() (fused=
                # False): the staged chain
                mc = StagedMulticarrierFrontend.from_offsets(
                    offsets, device=self.device)
                dec = MulticarrierDecoder(len(hot), auto_decrypt=False,
                                          device=self.device)
                res = mc(np.asarray(samples[:usable], np.complex64))
                for entry, frames_c in zip(hot, dec.decode(res)):
                    crc_pass = sum(1 for fr in frames_c
                                   if fr.get("burst_crc"))
                    entry["frames_validated"] = len(frames_c) >= 2 and \
                        crc_pass > len(frames_c) * 0.5
                    entry["crc_pass_rate"] = crc_pass / max(len(frames_c), 1)
                    entry["sync_detected"] = len(frames_c) > 0
                    if entry["frames_validated"]:
                        entry["is_tetra"] = True
                        entry["confidence"] = max(entry["confidence"], 0.7)
        self.found_channels = [r for r in results if r["is_tetra"]] or \
            self.found_channels
        return results

    def get_found_channels(self) -> List[Dict]:
        return self.found_channels

    def print_found_channels(self) -> None:
        if not self.found_channels:
            logger.info("No TETRA channels found")
            return
        logger.info("%s", "=" * 80)
        logger.info("Found TETRA Channels:")
        logger.info("%-18s %-12s %-12s %-8s",
                    "Frequency (MHz)", "Power (dB)", "Confidence", "Sync")
        for ch in self.found_channels:
            logger.info("%15.3f     %8.1f     %8.2f     %6s",
                        ch["frequency_mhz"], ch["power_db"], ch["confidence"],
                        "Yes" if ch.get("sync_detected", False) else "No")
        logger.info("%s", "=" * 80)
