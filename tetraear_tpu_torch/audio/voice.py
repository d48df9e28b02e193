"""ETSI ACELP voice decode via the codec executables (copy of the
reference's `audio/voice.py`, whose behaviour it keeps).

The codec is the ETSI EN 300 395-2 reference C implementation run as two
subprocesses per time-slot block:

    cdecoder  soft bits (690 x int16, header 0x6B21) -> serial vocoder bits
              ((BFI + 137) x int16 per speech frame, 2 frames = 552 B)
    sdecoder  serial bits -> 8 kHz int16 PCM

Host-side by design (the voice codec stays on the host).  On Linux the
binaries are looked up without the .exe suffix first.  The default
binaries are the repo's own spec-derived implementation in native/codec/
(real ACELP synthesis + real UEP channel decoding, see
native/codec/tetra_codec.h for the scope note): `build_codec` compiles
them with the host's C compiler into build/codec/ on first use, never
into native/.  A genuine ETSI build in TETRAEAR_TPU_CODEC_DIR takes their
place with no code change.  When no binaries are present (no compiler)
the processor reports not-working and decode_frame returns an empty
array, as the reference does without its bundled executables; that is
host behaviour, not a device fallback.
"""

from __future__ import annotations

import hashlib
import logging
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

import numpy as np

from tetraear_tpu_torch import constants as C
from tetraear_tpu_torch.audio.blocks import validate_block

logger = logging.getLogger(__name__)
codec_logger = logging.getLogger("tetraear_tpu_torch.codec")

_CODEC_TIMEOUT_S = 5


def _stream_timeout_s(input_bytes: int) -> float:
    """Subprocess budget for whole-stream codec invocations.

    The reference's 5 s is a PER-FRAME timeout (voice.py:124); the
    streaming paths (decode_stream, encode_pcm) feed arbitrarily long
    inputs through one invocation, where a fixed 5 s becomes a silent
    ~6-minute input cap.  Scale with input size: measured ~0.45 s per
    30 s of audio (~1 s/MB), budgeted at 5 s/MB + the 5 s base.  For a
    single 1380-byte frame this stays the contract's 5 s."""
    return _CODEC_TIMEOUT_S + input_bytes / 2e5


_REPO = Path(__file__).resolve().parents[2]
CODEC_SRC = _REPO / "native" / "codec"
CODEC_BUILD = _REPO / "build" / "codec"
CODEC_CFLAGS = ("-O2", "-Wall", "-Wextra", "-std=c11")
CODEC_PROGRAMS = ("scoder", "sdecoder", "ccoder", "cdecoder")
_CODEC_CORE = ("tetra_dsp.c", "tetra_celp.c", "tetra_channel.c")


def build_codec() -> Optional[Path]:
    """native/codec's four programs (as its Makefile builds them),
    compiled by the host's C compiler ($CC, else cc) into
    build/codec/<digest>/ once per version of the sources; None when
    there is no compiler or it refuses a source.  Processes may build at
    once: each builds into a temporary directory and renames it into
    place."""
    cc = os.environ.get("CC") or shutil.which("cc")
    sources = sorted(CODEC_SRC.glob("*.[ch]"))
    if cc is None or not sources:
        return None
    digest = hashlib.sha256(b"\0".join(
        [p.read_bytes() for p in sources] + [" ".join(CODEC_CFLAGS).encode()])
    ).hexdigest()[:16]
    out = CODEC_BUILD / digest
    if all((out / p).exists() for p in CODEC_PROGRAMS):
        return out
    try:
        CODEC_BUILD.mkdir(parents=True, exist_ok=True)
        tmp = Path(tempfile.mkdtemp(dir=CODEC_BUILD))
    except OSError as e:
        logger.debug("codec build error: %s", e)
        return None
    try:
        for prog in CODEC_PROGRAMS:
            result = subprocess.run(
                [cc, *CODEC_CFLAGS, f"{prog}.c", *_CODEC_CORE, "-o",
                 str(tmp / prog), "-lm"], cwd=CODEC_SRC,
                capture_output=True, timeout=300)
            if result.returncode != 0:
                logger.debug("codec %s build failed: %s", prog,
                             result.stderr.decode("utf-8", "ignore")[-400:])
                return None
        try:
            os.replace(tmp, out)
        except OSError:          # another process put its build there first
            pass
    except (OSError, subprocess.SubprocessError) as e:
        logger.debug("codec build error: %s", e)
        return None
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out if all((out / p).exists() for p in CODEC_PROGRAMS) else None


def _default_codec_dir() -> Path:
    """TETRAEAR_TPU_CODEC_DIR, else the programs built from native/codec
    (a directory with no programs when they cannot be built)."""
    env_dir = os.environ.get("TETRAEAR_TPU_CODEC_DIR")
    if env_dir:
        return Path(env_dir)
    return build_codec() or CODEC_BUILD / "unavailable"


def _find_exe(directory: Path, stem: str) -> Path:
    """Prefer the native binary; fall back to the .exe name."""
    native = directory / stem
    if native.exists():
        return native
    return directory / f"{stem}.exe"


class VoiceProcessor:
    """Two-stage subprocess codec wrapper."""

    def __init__(self, codec_path=None, cdecoder_path=None,
                 sdecoder_path=None, codec_dir=None):
        if codec_dir is not None:
            resolved = Path(codec_dir)
        elif cdecoder_path is not None or codec_path is not None:
            resolved = Path(cdecoder_path or codec_path).resolve().parent
        else:
            resolved = _default_codec_dir()

        self.cdecoder_path = (Path(cdecoder_path or codec_path)
                              if (cdecoder_path or codec_path) is not None
                              else _find_exe(resolved, "cdecoder"))
        self.sdecoder_path = (Path(sdecoder_path) if sdecoder_path is not None
                              else _find_exe(resolved, "sdecoder"))

        self.channel_decoder_available = self.cdecoder_path.exists()
        self.speech_decoder_available = self.sdecoder_path.exists()
        self.working = (self.channel_decoder_available
                        and self.speech_decoder_available)
        # Context priming for per-block decode: the speech decoder loses
        # all state (adaptive-codebook history, synthesis/postfilter
        # memory) when invoked per 690-short block, the contract the
        # reference inherits from its prebuilt binaries
        # (voice.py:159-208).  Prepending the previous blocks' serial
        # bits as warm-up and keeping only the tail recovers streaming
        # quality (tools/codec_quality.py measures the per-block segSNR
        # bare, with context blocks and streaming).
        try:
            self.context_blocks = max(0, int(os.environ.get(
                "TETRAEAR_CODEC_CONTEXT", "4")))
        except ValueError:
            self.context_blocks = 4
        self._serial_ctx: list[bytes] = []
        if not self.channel_decoder_available:
            logger.warning("TETRA codec channel decoder not found at %s",
                           self.cdecoder_path)
        if not self.speech_decoder_available:
            logger.warning("TETRA codec speech decoder not found at %s",
                           self.sdecoder_path)

    def decode_frame(self, frame_data: bytes) -> np.ndarray:
        """690-short block -> float32 PCM in [-1, 1]; empty on failure."""
        if not self.working or not frame_data:
            return np.zeros(0)
        if not validate_block(frame_data):
            logger.debug("Invalid codec block (%d bytes)", len(frame_data))
            self._serial_ctx.clear()
            return np.zeros(0)

        keep_temp = os.environ.get("TETRAEAR_KEEP_CODEC_TEMP", "").strip(
            ).lower() in ("1", "true", "yes", "y")
        with tempfile.NamedTemporaryFile(mode="wb", delete=False,
                                         suffix=".tet") as tmp_in:
            tmp_in.write(frame_data)
            in_path = Path(tmp_in.name)
        serial_path = Path(str(in_path) + ".serial")
        synth_path = Path(str(in_path) + ".synth")

        def _cleanup():
            if keep_temp:
                return
            for p in (in_path, serial_path, synth_path):
                try:
                    p.unlink(missing_ok=True)
                except Exception:
                    pass

        try:
            if not self._run_stage(self.cdecoder_path, in_path, serial_path):
                self._serial_ctx.clear()
                _cleanup()
                return np.zeros(0)
            self._log_bfi(serial_path)
            # warm-up context: prepend previous blocks' serial bits so
            # the fresh sdecoder process rebuilds its excitation/synthesis
            # state, then keep only this block's samples
            serial_cur = serial_path.read_bytes()
            n_warm = 0
            if (self.context_blocks > 0
                    and len(serial_cur) == 2 * 138 * 2
                    and self._serial_ctx):
                ctx = self._serial_ctx[-self.context_blocks:]
                serial_path.write_bytes(b"".join(ctx) + serial_cur)
                n_warm = 480 * len(ctx)
            if not self._run_stage(self.sdecoder_path, serial_path, synth_path):
                self._serial_ctx.clear()
                _cleanup()
                return np.zeros(0)

            pcm = np.frombuffer(synth_path.read_bytes(), dtype=np.int16)
            pcm = pcm[n_warm:]
            if pcm.size == 0:
                self._serial_ctx.clear()
                _cleanup()
                return np.zeros(0)
            if self.context_blocks > 0 and len(serial_cur) == 2 * 138 * 2:
                self._serial_ctx.append(serial_cur)
                del self._serial_ctx[:-self.context_blocks]
            audio = pcm.astype(np.float32) / 32768.0
            max_amp = float(np.max(np.abs(audio)))
            codec_logger.debug("Codec produced %d samples (max amp %.4f)",
                               audio.size, max_amp)
            # near-silent output == decode failure (voice.py:222-232)
            if max_amp < 1e-5:
                codec_logger.debug("Near-silent codec output; treating as "
                                   "decode failure")
                _cleanup()
                return np.zeros(0)
            _cleanup()
            logger.info("Decoded %d audio samples from voice frame", audio.size)
            return audio
        except Exception as e:
            logger.debug("Voice decode error: %s", e)
            self._serial_ctx.clear()
            _cleanup()
            return np.zeros(0)

    def reset_context(self) -> None:
        """Drop the warm-up serial context (call at call/stream
        boundaries so one call's tail cannot prime another's start)."""
        self._serial_ctx.clear()

    def decode_stream(self, blocks) -> np.ndarray:
        """Decode a SEQUENCE of 690-short blocks in one codec invocation
        pair, preserving decoder state (excitation history, synthesis
        memory) across blocks — the high-quality path for accumulated
        voice (downlink TCH/S streams, call recordings).  Per-block
        `decode_frame` adds serial warm-up context by default and is
        therefore history-dependent; it matches the reference's
        stateless per-block contract exactly when the context is empty
        (fresh instance / after reset_context(), pinned by
        tests/conformance/test_reference_ab.py)."""
        blocks = [b for b in blocks if b and validate_block(b)]
        if not self.working or not blocks:
            return np.zeros(0)
        with tempfile.NamedTemporaryFile(mode="wb", delete=False,
                                         suffix=".tet") as tmp_in:
            for b in blocks:
                tmp_in.write(b)
            in_path = Path(tmp_in.name)
        serial_path = Path(str(in_path) + ".serial")
        synth_path = Path(str(in_path) + ".synth")
        try:
            if not self._run_stage(self.cdecoder_path, in_path,
                                   serial_path):
                return np.zeros(0)
            if not self._run_stage(self.sdecoder_path, serial_path,
                                   synth_path):
                return np.zeros(0)
            pcm = np.frombuffer(synth_path.read_bytes(), dtype=np.int16)
            return pcm.astype(np.float32) / 32768.0
        except Exception as e:
            logger.debug("Voice stream decode error: %s", e)
            return np.zeros(0)
        finally:
            for p in (in_path, serial_path, synth_path):
                try:
                    p.unlink(missing_ok=True)
                except Exception:
                    pass

    def _run_stage(self, exe: Path, inp: Path, outp: Path) -> bool:
        codec_logger.debug("Calling %s %s %s", exe, inp, outp)
        try:
            result = subprocess.run(
                [str(exe), str(inp.resolve()), str(outp.resolve())],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                check=False,
                timeout=_stream_timeout_s(inp.stat().st_size))
        except subprocess.TimeoutExpired:
            codec_logger.debug("%s timed out", exe.name)
            return False
        if result.stdout:
            codec_logger.debug("STDOUT: %s",
                               result.stdout.decode("utf-8", "ignore").strip())
        if result.stderr:
            codec_logger.debug("STDERR: %s",
                               result.stderr.decode("utf-8", "ignore").strip())
        if result.returncode != 0:
            codec_logger.debug("%s failed with return code %s",
                               exe.name, result.returncode)
        return outp.exists() and outp.stat().st_size > 0

    def _log_bfi(self, serial_path: Path) -> None:
        """Sanity-log the BFI words of the serial output (voice.py:159-171)."""
        try:
            raw = serial_path.read_bytes()[:552]
            if len(raw) >= 2:
                bfi1 = int.from_bytes(raw[0:2], "little", signed=True)
                bfi2 = None
                if len(raw) >= 278:
                    bfi2 = int.from_bytes(raw[276:278], "little", signed=True)
                codec_logger.debug("cdecoder BFI: frame1=%s frame2=%s",
                                   bfi1, bfi2)
        except Exception:
            pass


class VoiceEncoder:
    """Encode-direction wrapper (scoder + ccoder): PCM -> coded TCH/S
    blocks.  The transmit-side mirror of VoiceProcessor, used by
    `downlink --simulate` to put REAL coded speech over the air and by
    the codec round-trip tests (the reference only ships the encoders
    for its verify tool, tools/verify_codec.py:152-210)."""

    def __init__(self, codec_dir=None):
        resolved = (Path(codec_dir) if codec_dir is not None
                    else _default_codec_dir())
        self.scoder_path = _find_exe(resolved, "scoder")
        self.ccoder_path = _find_exe(resolved, "ccoder")
        self.working = (self.scoder_path.exists()
                        and self.ccoder_path.exists())

    def encode_pcm(self, pcm) -> list:
        """int16 PCM @ 8 kHz -> list of 690-short .tet blocks (bytes).
        Returns [] on any failure."""
        if not self.working:
            return []
        pcm = np.asarray(pcm, np.int16)
        with tempfile.NamedTemporaryFile(mode="wb", delete=False,
                                         suffix=".pcm") as tmp:
            tmp.write(pcm.tobytes())
            pcm_path = Path(tmp.name)
        serial_path = Path(str(pcm_path) + ".serial")
        tet_path = Path(str(pcm_path) + ".tet")
        try:
            for exe, inp, outp in ((self.scoder_path, pcm_path, serial_path),
                                   (self.ccoder_path, serial_path, tet_path)):
                result = subprocess.run(
                    [str(exe), str(inp.resolve()), str(outp.resolve())],
                    stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                    check=False,
                    timeout=_stream_timeout_s(inp.stat().st_size))
                if result.returncode != 0 or not outp.exists():
                    return []
            raw = tet_path.read_bytes()
            nblk = len(raw) // C.CODEC_BLOCK_BYTES
            return [raw[i * C.CODEC_BLOCK_BYTES:(i + 1) * C.CODEC_BLOCK_BYTES]
                    for i in range(nblk)]
        except Exception as e:
            logger.debug("Voice encode error: %s", e)
            return []
        finally:
            for p in (pcm_path, serial_path, tet_path):
                try:
                    p.unlink(missing_ok=True)
                except Exception:
                    pass

    def encode_pcm_bits(self, pcm) -> "np.ndarray":
        """int16 PCM -> (M, 432) uint8 coded bits (over-the-air TCH/S
        payloads for DownlinkTransmitter tch_streams)."""
        from tetraear_tpu_torch.audio.blocks import bits_from_tet_block
        blocks = self.encode_pcm(pcm)
        if not blocks:
            return np.zeros((0, 432), np.uint8)
        return np.stack([bits_from_tet_block(b) for b in blocks])
