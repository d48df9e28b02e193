"""Headless attempt-loop capture: keep capturing until readable text or
non-silent voice is found (the port's copy of tools/auto_capture.py, the
receive loop on --device).

Writes logs/auto_<run>_NN.jsonl per attempt and records/auto_voice_<run>_
NN.wav under the working directory; exits 1 when no attempt hit.

    python -m tetraear_tpu_torch.tools.auto_capture
        [--iq-file f | --synthetic] [-f MHz] [-s MS/s] [--key-file keys]
        [--attempts N] [--chunks-per-attempt N] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
from pathlib import Path

from tetraear_tpu_torch.tools._capture import (add_source_args, capture_loop,
                                               run_id, voice_audio)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m tetraear_tpu_torch.tools.auto_capture")
    add_source_args(ap)
    ap.add_argument("--key-file", type=str, default=None)
    ap.add_argument("--attempts", type=int, default=10)
    ap.add_argument("--chunks-per-attempt", type=int, default=20)
    args = ap.parse_args(argv)

    from tetraear_tpu_torch.audio.export import write_wav
    from tetraear_tpu_torch.io.recorder import JsonlFrameRecorder
    from tetraear_tpu_torch.ui.cli import _device, _load_keys
    from tetraear_tpu_torch.utils.textscore import is_pure_ascii

    device = _device(args.device)
    log_dir = Path("logs")
    records_dir = Path("records")
    log_dir.mkdir(exist_ok=True)
    records_dir.mkdir(exist_ok=True)
    run = run_id()

    for attempt in range(1, args.attempts + 1):
        print(f"\n[ATTEMPT {attempt}/{args.attempts}]")
        loop = capture_loop(args, device, auto_decrypt=True)
        _load_keys(args, loop)
        found = {"hit": False}
        rec = JsonlFrameRecorder(log_dir / f"auto_{run}_{attempt:02d}.jsonl")

        def on_frame(frame):
            rec.write(frame)
            text = frame.get("decoded_text") or frame.get("sds_message") or ""
            if text and is_pure_ascii(text):
                print(f"[HIT] readable text: {text[:80]}")
                found["hit"] = True
            audio = voice_audio(loop, frame)
            if audio is not None:
                vfile = records_dir / f"auto_voice_{run}_{attempt:02d}.wav"
                write_wav(vfile, audio)
                print(f"[HIT] non-silent voice: {vfile.name}")
                found["hit"] = True

        loop.on_frame = on_frame
        try:
            loop.run(max_chunks=args.chunks_per_attempt)
        except KeyboardInterrupt:
            return 0
        finally:
            rec.close()
        if found["hit"]:
            print(f"[DONE] hit on attempt {attempt}")
            return 0
    print("[DONE] no readable text or voice found")
    return 1


if __name__ == "__main__":
    raise SystemExit(main())
