"""Codec verification: run the four codec programs and check their I/O
contracts on synthetic frames (the port's copy of tools/verify_codec.py;
host only).

Contracts (ETSI EN 300 395-2 reference implementation):
  cdecoder  690-short soft-bit block (header 0x6B21) -> (BFI+137) int16 x 2
            speech frames per channel frame (552 bytes)
  sdecoder  serial vocoder bits -> 8 kHz int16 PCM (480 samples / 60 ms)
  ccoder/scoder  encode direction (round-trip fixtures)

--codec-dir defaults to the port's codec: TETRAEAR_TPU_CODEC_DIR, else
the programs built from native/codec/ into build/codec/.  Without the
decoder programs it prints how the port gets them and exits 1.

    python -m tetraear_tpu_torch.tools.verify_codec [--codec-dir DIR]
"""

from __future__ import annotations

import argparse
import struct
import subprocess
import tempfile
from pathlib import Path

from tetraear_tpu_torch import constants as C


def find_codecs(codec_dir: Path) -> dict:
    out = {}
    for stem in ("cdecoder", "ccoder", "sdecoder", "scoder"):
        native = codec_dir / stem
        exe = codec_dir / f"{stem}.exe"
        out[stem] = (native if native.exists()
                     else exe if exe.exists() else None)
    return out


def synthetic_block() -> bytes:
    frame = bytearray(struct.pack("<H", C.CODEC_FRAME_HEADER))
    for i in range(C.CODEC_BLOCK_SHORTS - 1):
        frame.extend(struct.pack("<h", (i % 2) * 64))
    return bytes(frame)


def run(exe: Path, inp: Path, outp: Path) -> subprocess.CompletedProcess:
    return subprocess.run([str(exe), str(inp), str(outp)],
                          capture_output=True, timeout=10)


def check_cdecoder(exe: Path) -> bool:
    print("=" * 60)
    print("Testing cdecoder (channel decoder)")
    with tempfile.TemporaryDirectory() as td:
        inp = Path(td) / "in.tet"
        outp = Path(td) / "out.serial"
        inp.write_bytes(synthetic_block() * 3)
        result = run(exe, inp, outp)
        if not outp.exists() or outp.stat().st_size == 0:
            print(f"[FAIL] no output (rc={result.returncode})")
            return False
        size = outp.stat().st_size
        per_frame = 2 * C.CODEC_SERIAL_WORDS_PER_SPEECH_FRAME * 2
        print(f"[OK] serial output {size} bytes "
              f"({size / per_frame:.1f} channel frames of {per_frame} B)")
        raw = outp.read_bytes()
        if len(raw) >= 2:
            bfi = struct.unpack("<h", raw[:2])[0]
            print(f"[OK] first BFI word: {bfi}")
        return size % 2 == 0


def check_chain(cdec: Path, sdec: Path) -> bool:
    print("=" * 60)
    print("Testing cdecoder -> sdecoder chain")
    with tempfile.TemporaryDirectory() as td:
        inp = Path(td) / "in.tet"
        serial = Path(td) / "out.serial"
        synth = Path(td) / "out.synth"
        inp.write_bytes(synthetic_block())
        run(cdec, inp, serial)
        if not serial.exists() or serial.stat().st_size == 0:
            print("[FAIL] cdecoder produced nothing")
            return False
        run(sdec, serial, synth)
        if not synth.exists() or synth.stat().st_size == 0:
            print("[FAIL] sdecoder produced nothing")
            return False
        n = synth.stat().st_size // 2
        print(f"[OK] PCM output: {n} samples ({n / 8000:.3f} s @ 8 kHz)")
        return True


def check_scoder_roundtrip(scoder: Path, sdecoder: Path) -> bool:
    import numpy as np
    print("=" * 60)
    print("Testing scoder -> sdecoder round trip")
    with tempfile.TemporaryDirectory() as td:
        pcm_in = Path(td) / "speech.pcm"
        serial = Path(td) / "out.serial"
        pcm_out = Path(td) / "resynth.pcm"
        t = np.arange(480 * 4) / 8000.0
        tone = (np.sin(2 * np.pi * 440 * t) * 8000).astype(np.int16)
        pcm_in.write_bytes(tone.tobytes())
        run(scoder, pcm_in, serial)
        if not serial.exists() or serial.stat().st_size == 0:
            print("[FAIL] scoder produced nothing")
            return False
        run(sdecoder, serial, pcm_out)
        ok = pcm_out.exists() and pcm_out.stat().st_size > 0
        print("[OK] resynthesis produced audio" if ok else "[FAIL] no resynth")
        return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m tetraear_tpu_torch.tools.verify_codec")
    ap.add_argument("--codec-dir", type=Path, default=None,
                    help="the codec programs' directory (default: "
                         "TETRAEAR_TPU_CODEC_DIR, else the programs built "
                         "from native/codec into build/codec/)")
    args = ap.parse_args(argv)
    if args.codec_dir is None:
        from tetraear_tpu_torch.audio.voice import _default_codec_dir
        args.codec_dir = _default_codec_dir()

    codecs = find_codecs(args.codec_dir)
    print(f"Codec directory: {args.codec_dir}")
    for name, path in codecs.items():
        print(f"  {name}: {path if path else 'NOT FOUND'}")
    available = {k: v for k, v in codecs.items() if v}
    if not available.get("cdecoder") or not available.get("sdecoder"):
        print("\n[SKIP] decoder executables missing — the port builds "
              "them from native/codec/ with a C compiler (cc, or $CC); "
              "or pass --codec-dir / TETRAEAR_TPU_CODEC_DIR naming an ETSI "
              "EN 300 395-2 build")
        return 1

    ok = check_cdecoder(available["cdecoder"])
    ok &= check_chain(available["cdecoder"], available["sdecoder"])
    if available.get("scoder"):
        ok &= check_scoder_roundtrip(available["scoder"],
                                     available["sdecoder"])
    print("\n" + ("[PASS] codec verification complete" if ok
                  else "[FAIL] some codec checks failed"))
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
