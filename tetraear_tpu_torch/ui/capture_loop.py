"""The real-time receive loop (port of `tetraear_tpu.ui.capture_loop`)
— headless equivalent of the reference's ``CaptureThread.run``
(ui/modern.py:1863-2263) with callback hooks instead of Qt signals.

Per chunk: spectrum + detection gate + AFC -> demod -> decode -> per-frame
voice candidacy -> callbacks/recorders.  Runs inline (``run``) or on a
worker thread (``start``/``stop``).  The spectrum, the detection gate,
`SignalProcessor.process` and the decoder's dense sync scores run on the
loop's `device`; the MAC/SDS decode, the overlap dedup, the raw-audio
monitor and the voice candidacy are the reference's host code.

Where the port differs from the reference on purpose: the reference
catches every exception of a chunk's demod and decode ("Decode error",
logged at DEBUG, the loop goes on) and every exception of the loop
("Fatal error", reported through on_error, after which `listen` exits
0).  Here the device calls sit outside the per-chunk catch, which keeps
guarding the host decode of bad input, and the outer handler re-raises
after on_error: a failed kernel build or launch, a CUDA error or an
out-of-memory ends the run with the exception instead of reading as "no
signal".
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Optional

import numpy as np
import torch

from tetraear_tpu_torch import constants as C
from tetraear_tpu_torch.config import ReceiverConfig

logger = logging.getLogger(__name__)
audio_logger = logging.getLogger("tetraear_tpu_torch.recording")


class CaptureLoop:
    """Source-agnostic capture/decode loop.

    Callbacks (all optional):
      on_status(str), on_error(str), on_signal(freq, power),
      on_signal_lost(), on_frame(dict), on_spectrum(freqs, power),
      on_voice_audio(np.ndarray), on_raw_audio(np.ndarray)
    """

    def __init__(self, source, frequency: float = 390.865e6,
                 sample_rate: float = 2.4e6, auto_decrypt: bool = True,
                 monitor_raw: bool = False, chunk_size: int = 128 * 1024,
                 encryption_keys: Optional[list] = None,
                 records_dir: Optional[str] = None,
                 always_decode: bool = False, afc: bool = True,
                 overlap: int = 0,
                 receiver_config: Optional[ReceiverConfig] = None, *,
                 device):
        self.source = source
        self.device = torch.device(device)
        self.frequency = frequency
        self.sample_rate = sample_rate
        self.auto_decrypt = auto_decrypt
        self.monitor_raw = monitor_raw
        self.chunk_size = chunk_size
        self.encryption_keys = encryption_keys or []
        self.records_dir = records_dir
        # CLI scripts decode every chunk regardless of the detection gate
        # (continuous_capture.py:50-56); the GUI loop gates on signal.
        self.always_decode = always_decode
        # peak-bin AFC (ui/modern.py:1967-1974, :2028); disable for replay of
        # already-centered recordings where the modulation peak != carrier
        self.afc = afc
        # IQ overlap between chunks: the reference loses frames straddling
        # chunk edges (modern.py:1915-1917 sizes chunks to make that rare);
        # a nonzero overlap re-presents the boundary region and decoded
        # duplicates are dropped by frame-bits hash
        self.overlap = overlap
        self.receiver_config = receiver_config
        self._tail = None
        self._recent_hashes = []

        self.running = False
        self.pending_freq: Optional[float] = None
        self.last_signal_time = 0.0
        self.chunks_processed = 0
        self.frames_decoded = 0
        from tetraear_tpu_torch.utils.metrics import ThroughputMeter
        self.meter = ThroughputMeter()

        # callbacks
        self.on_status: Callable = lambda msg: None
        self.on_error: Callable = lambda msg: None
        self.on_signal: Callable = lambda freq, power: None
        self.on_signal_lost: Callable = lambda: None
        self.on_frame: Callable = lambda frame: None
        self.on_spectrum: Callable = lambda freqs, power: None
        self.on_voice_audio: Callable = lambda audio: None
        self.on_raw_audio: Callable = lambda audio: None

        self._thread: Optional[threading.Thread] = None
        self._raw_frame_recorder = None
        self.processor = None
        self.decoder = None
        self.voice_processor = None

    # ------------------------------------------------------------------
    def set_frequency(self, freq: float) -> None:
        self.pending_freq = freq

    def set_keys(self, keys) -> None:
        self.encryption_keys = list(keys)
        if self.decoder:
            self.decoder.set_keys(self.encryption_keys)

    def start(self) -> None:
        self._thread = threading.Thread(target=self.run, daemon=True)
        self._thread.start()

    def stop(self, join: bool = True) -> None:
        self.running = False
        if join and self._thread is not None:
            self._thread.join(timeout=10)

    # ------------------------------------------------------------------
    def _init_pipeline(self) -> bool:
        from tetraear_tpu_torch.audio.voice import VoiceProcessor
        from tetraear_tpu_torch.core.decoder import TetraDecoder
        from tetraear_tpu_torch.models.receiver import SignalProcessor

        self.on_status("Initializing source...")
        if not self.source.open():
            self.on_error("Failed to open capture source")
            return False
        self.processor = SignalProcessor(sample_rate=self.sample_rate,
                                         config=self.receiver_config,
                                         device=self.device)
        self.decoder = TetraDecoder(auto_decrypt=self.auto_decrypt,
                                    device=self.device)
        logger.info("Auto-Decrypt: %s", "ON" if self.auto_decrypt else "OFF")
        if self.encryption_keys:
            self.decoder.set_keys(self.encryption_keys)
        self.voice_processor = VoiceProcessor()
        self.on_status(f"Started - {self.frequency / 1e6:.3f} MHz")
        return True

    def run(self, max_chunks: Optional[int] = None) -> None:
        from tetraear_tpu_torch.ops import spectrum as spec_ops

        self.running = True
        last_spectrum_update = 0.0
        last_status_update = 0.0
        try:
            if not self._init_pipeline():
                return
            while self.running:
                if max_chunks is not None and self.chunks_processed >= max_chunks:
                    break
                if self.pending_freq is not None:
                    try:
                        new_freq, self.pending_freq = self.pending_freq, None
                        self.frequency = new_freq
                        self.source.set_frequency(new_freq)
                        # new carrier = new voice stream: stale serial
                        # context must not prime the next call's decode
                        self.voice_processor.reset_context()
                    except Exception as e:
                        self.on_error(f"Failed to set frequency: {e}")

                try:
                    samples = self.source.read_samples(self.chunk_size)
                except RuntimeError as e:
                    self.on_error(f"Device error: {e}. Please restart.")
                    self.running = False
                    break
                if samples is None or len(samples) == 0:
                    break
                self.chunks_processed += 1
                if self.overlap > 0:
                    if self._tail is not None and len(self._tail) > 0:
                        samples = np.concatenate([self._tail, samples])
                    self._tail = samples[-self.overlap:].copy()

                signal_present = False
                afc_offset = 0.0
                n_fft = C.SPECTRUM_FFT_SIZE
                if len(samples) >= n_fft:
                    power_dev = spec_ops.spectrum_dbfs(torch.as_tensor(
                        np.asarray(samples[:n_fft], np.complex64),
                        device=self.device))
                    power = power_dev.cpu().numpy()
                    freqs = spec_ops.fft_freqs(n_fft, self.sample_rate)
                    now = time.time()
                    if now - last_spectrum_update >= 0.005:
                        self.on_spectrum(freqs + self.frequency, power)
                        last_spectrum_update = now
                    det = spec_ops.detect_signal(power_dev,
                                                 self.sample_rate, n_fft)
                    is_strong = bool(det.signal_present)
                    if is_strong:
                        self.last_signal_time = now
                        signal_present = True
                        if self.afc and float(det.peak_power) > C.DETECT_PEAK_DBFS:
                            afc_offset = float(det.afc_offset_hz)
                    if now - last_status_update >= 0.1:
                        if is_strong:
                            self.on_signal(self.frequency,
                                           float(det.signal_power))
                        elif now - self.last_signal_time > \
                                C.DETECT_LOSS_HYSTERESIS_S:
                            self.on_signal_lost()
                        last_status_update = now

                if not (signal_present or self.always_decode):
                    continue
                # device work, outside the host decode's catch
                demodulated = self.processor.process(
                    samples, freq_offset=afc_offset if signal_present else 0)
                self._maybe_raw_audio(samples)
                if demodulated is None or len(demodulated) < C.SYMBOLS_PER_SLOT:
                    scored = None
                else:
                    scored = self.decoder.sync_scores(demodulated)
                try:
                    frames = self.decoder.decode_scored(scored)
                    emitted = 0
                    for frame in frames:
                        if self.overlap > 0 and self._is_duplicate(frame):
                            continue
                        self.frames_decoded += 1
                        emitted += 1
                        self._maybe_voice(frame)
                        self.on_frame(frame)
                    self.meter.record(len(samples), emitted)
                except Exception as e:
                    logger.debug("Decode error: %s", e)
        except Exception as e:
            self.on_error(f"Fatal error: {e}")
            logger.exception("Capture loop fatal error")
            raise
        finally:
            try:
                self.source.close()
            except Exception:
                pass
            self.on_status("Stopped")

    def _is_duplicate(self, frame: dict) -> bool:
        """Drop re-decoded frames from the overlap region (bits hash)."""
        import hashlib
        bits = frame.get("bits")
        if bits is None:
            return False
        h = hashlib.md5(np.asarray(bits, np.uint8).tobytes()).hexdigest()
        if h in self._recent_hashes:
            return True
        self._recent_hashes.append(h)
        if len(self._recent_hashes) > 64:
            self._recent_hashes = self._recent_hashes[-64:]
        return False

    # ------------------------------------------------------------------
    def _maybe_raw_audio(self, samples: np.ndarray) -> None:
        """FM-demod 'buzz' monitor at 48 kHz (modern.py:2047-2068)."""
        if not self.monitor_raw:
            return
        try:
            decimation = int(self.sample_rate / 48000)
            if decimation > 0:
                audio_samples = samples[::decimation]
                if len(audio_samples) > 1:
                    from tetraear_tpu_torch.utils import native_dsp
                    audio = native_dsp.fm_discriminator(audio_samples)
                    if audio is None:
                        audio = np.angle(audio_samples[1:]
                                         * np.conj(audio_samples[:-1])
                                         ) / np.pi * 0.5
                    self.on_raw_audio(audio)
        except Exception:
            pass

    def _maybe_voice(self, frame: dict) -> None:
        """Voice candidacy + codec decode (modern.py:2092-2235)."""
        try:
            if not (self.voice_processor and self.voice_processor.working):
                return
            mac_pdu = frame.get("mac_pdu", {})
            pdu_type = str(mac_pdu.get("type", ""))
            is_encrypted = frame.get("encrypted", False)
            is_candidate = (("FRAG" in pdu_type or frame.get("type") == 1)
                            and (not is_encrypted or frame.get("decrypted")))
            if not is_candidate:
                return

            from tetraear_tpu_torch.audio import blocks
            voice_bits = frame.get("bits")
            if frame.get("decrypted") and "decrypted_payload" in frame:
                try:
                    voice_bits = np.array(
                        [int(b) for b in frame["decrypted_payload"]],
                        dtype=np.uint8)
                except Exception:
                    pass
            codec_input = None
            if voice_bits is not None and len(voice_bits) >= 432:
                codec_input = blocks.block_from_hard_bits(voice_bits)
            if codec_input is None:
                return
            if self.records_dir is not None:
                if self._raw_frame_recorder is None:
                    from tetraear_tpu_torch.io.recorder import RawFrameRecorder
                    self._raw_frame_recorder = RawFrameRecorder(
                        self.records_dir, self.frequency)
                    audio_logger.info("Recording raw frames: %s",
                                      self._raw_frame_recorder.path.name)
                self._raw_frame_recorder.append(codec_input)
            audio = self.voice_processor.decode_frame(codec_input)
            if len(audio) > 0:
                frame["has_voice"] = True
                self.on_voice_audio(audio)
                audio_logger.info("Decoded voice: %s samples from frame %s",
                                  len(audio), frame.get("number"))
        except Exception as e:
            logger.debug("Voice decode error: %s", e)
