"""BladeRF capture driver (hardware-gated).

Behavioral parity with tetraear/signal/capture.py:41-328 where hardware is
present; on hosts without libbladeRF the module degrades to enumeration
stubs and the replay sources in io/replay.py carry ingestion.

The reference's per-sample struct-unpack loop (capture.py:259-267, its
single biggest CPU cost) is replaced with one vectorized
``np.frombuffer(...).astype(float32)/2048`` conversion.
"""

from __future__ import annotations

import logging
from typing import List, Optional

import numpy as np

logger = logging.getLogger(__name__)

try:  # pragma: no cover - hardware path
    import bladerf  # type: ignore
    BLADERF_AVAILABLE = True
except Exception:
    bladerf = None
    BLADERF_AVAILABLE = False


def list_bladerf_devices() -> List[dict]:
    """Enumerate connected BladeRF devices (capture.py:41-85)."""
    if not BLADERF_AVAILABLE:
        logger.warning("bladerf module not available")
        return []
    devices = []
    try:
        for info in bladerf.get_device_list():
            devices.append({
                "serial": getattr(info, "serial", ""),
                "usb_bus": getattr(info, "usb_bus", None),
                "usb_addr": getattr(info, "usb_addr", None),
                "instance": getattr(info, "instance", None),
            })
    except Exception as e:
        logger.error("Device enumeration failed: %s", e)
    return devices


class BladeRFCapture:
    """Synchronous-RX capture (capture.py:87-328 surface)."""

    READ_TIMEOUT_MS = 5000

    def __init__(self, frequency: float = 390.865e6, sample_rate: float = 2.4e6,
                 gain=50, device_identifier: Optional[str] = None):
        self.frequency = frequency
        self.sample_rate = sample_rate
        self.gain = gain
        self.device_identifier = device_identifier
        self.sdr = None
        self._channel = None

    def open(self) -> bool:
        if not BLADERF_AVAILABLE:
            logger.error("bladerf module not available - cannot open device")
            return False
        try:
            ident = (f"*:serial={self.device_identifier}"
                     if self.device_identifier else None)
            self.sdr = bladerf.BladeRF(ident) if ident else bladerf.BladeRF()
            ch = self.sdr.Channel(bladerf.CHANNEL_RX(0))
            ch.frequency = int(self.frequency)
            ch.sample_rate = int(self.sample_rate)
            ch.bandwidth = int(min(self.sample_rate, 56e6))
            if isinstance(self.gain, str) and self.gain.lower() == "auto":
                ch.gain_mode = bladerf.GainMode.Default
            else:
                ch.gain_mode = bladerf.GainMode.Manual
                ch.gain = int(self.gain)
            self.sdr.sync_config(
                layout=bladerf.ChannelLayout.RX_X1,
                fmt=bladerf.Format.SC16_Q11,
                num_buffers=16, buffer_size=8192,
                num_transfers=8, stream_timeout=self.READ_TIMEOUT_MS)
            ch.enable = True
            self._channel = ch
            logger.info("BladeRF opened: %.3f MHz @ %.1f MS/s",
                        self.frequency / 1e6, self.sample_rate / 1e6)
            return True
        except Exception as e:
            logger.error("Failed to open BladeRF: %s", e)
            self.sdr = None
            return False

    def read_samples(self, num_samples: int) -> np.ndarray:
        """Blocking sync_rx read -> complex64 normalized by 2048 (SC16-Q11).

        Vectorized conversion (the reference unpacks per sample,
        capture.py:259-267)."""
        if self.sdr is None:
            raise RuntimeError("Device not open")
        try:
            buf = bytearray(num_samples * 4)
            self.sdr.sync_rx(buf, num_samples,
                             timeout_ms=self.READ_TIMEOUT_MS)
            raw = np.frombuffer(bytes(buf), dtype=np.int16)
            from tetraear_tpu_torch.utils import native_dsp
            out = native_dsp.sc16q11_to_cf32(raw)
            if out is not None:
                return out
            iq = raw.astype(np.float32).reshape(-1, 2) / 2048.0
            return (iq[:, 0] + 1j * iq[:, 1]).astype(np.complex64)
        except Exception as e:
            logger.error("sync_rx failed: %s", e)
            self.close()
            raise RuntimeError(f"BladeRF read failed: {e}") from e

    def set_frequency(self, frequency: float) -> None:
        self.frequency = frequency
        if self._channel is not None:
            self._channel.frequency = int(frequency)

    def close(self) -> None:
        try:
            if self._channel is not None:
                self._channel.enable = False
            if self.sdr is not None:
                self.sdr.close()
        except Exception:
            pass
        finally:
            self.sdr = None
            self._channel = None
