"""Continuous capture: JSONL-log every decoded frame and attempt a voice
decode on each (the port's copy of tools/continuous_capture.py, the
receive loop on --device).

Writes logs/continuous_<run>.jsonl and records/voice_<run>_NNNN.wav
under the working directory.

    python -m tetraear_tpu_torch.tools.continuous_capture
        [--iq-file f | --synthetic] [-f MHz] [-s MS/s] [--max-chunks N]
        [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
from pathlib import Path

from tetraear_tpu_torch.tools._capture import (add_source_args, capture_loop,
                                               run_id, voice_audio)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m tetraear_tpu_torch.tools.continuous_capture")
    add_source_args(ap)
    ap.add_argument("--max-chunks", type=int, default=None)
    args = ap.parse_args(argv)

    from tetraear_tpu_torch.audio.export import write_wav
    from tetraear_tpu_torch.io.recorder import JsonlFrameRecorder
    from tetraear_tpu_torch.ui.cli import _device

    device = _device(args.device)
    log_dir = Path("logs")
    records_dir = Path("records")
    log_dir.mkdir(exist_ok=True)
    records_dir.mkdir(exist_ok=True)
    run = run_id()
    frames_log = log_dir / f"continuous_{run}.jsonl"

    loop = capture_loop(args, device, auto_decrypt=False)

    print(f"[INFO] Continuous capture at {args.frequency:.3f} MHz")
    print(f"[INFO] Frames log: {frames_log}")
    print("[INFO] Looking for unencrypted frames and voice...")

    state = {"frames": 0, "clear": 0, "voice": 0}
    rec = JsonlFrameRecorder(frames_log)

    def on_frame(frame):
        state["frames"] += 1
        rec.write(frame)
        if not frame.get("encrypted", True):
            state["clear"] += 1
            text = (frame.get("decoded_text", "")
                    or frame.get("sds_message", ""))
            if text and not text.startswith("[BIN"):
                clean = (text.replace("[GSM7]", "").replace("[LOC]", "")
                         .strip())
                alpha = sum(1 for c in clean if c.isalpha() and ord(c) < 128)
                if alpha > 3:
                    print(f"[READABLE!] Frame {state['frames']}: {text[:100]}")
                else:
                    print(f"[UNENCRYPTED] Frame {state['frames']}: "
                          f"type={frame.get('type_name')}, text={text[:50]}")
            else:
                print(f"[UNENCRYPTED] Frame {state['frames']}: "
                      f"type={frame.get('type_name')}, no text")
        audio = voice_audio(loop, frame)
        if audio is not None:
            state["voice"] += 1
            vfile = records_dir / f"voice_{run}_{state['voice']:04d}.wav"
            write_wav(vfile, audio)
            print(f"[VOICE] Frame {state['frames']}: saved {vfile.name}")
        if state["frames"] % 100 == 0:
            print(f"[STATUS] Frames: {state['frames']}, "
                  f"Unencrypted: {state['clear']}, Voice: {state['voice']}")

    loop.on_frame = on_frame
    try:
        loop.run(max_chunks=args.max_chunks)
    except KeyboardInterrupt:
        pass
    finally:
        rec.close()
    print(f"\n[DONE] Captured {state['frames']} frames, "
          f"{state['clear']} unencrypted, {state['voice']} voice")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
