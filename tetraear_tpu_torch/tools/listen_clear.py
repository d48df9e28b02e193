"""Listen for clear (unencrypted) TETRA traffic: pure-ASCII text, and
voice calls accumulated into clips of 3 s or more (the port's copy of
tools/listen_clear.py, the receive loop on --device).

Writes logs/clear_text_<run>.txt and records/clear_voice_<run>_NNNN.wav
under the working directory.

    python -m tetraear_tpu_torch.tools.listen_clear
        [--iq-file f | --synthetic] [-f MHz] [-s MS/s] [--max-chunks N]
        [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import time
from datetime import datetime
from pathlib import Path

from tetraear_tpu_torch.tools._capture import (add_source_args, capture_loop,
                                               run_id, voice_audio)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m tetraear_tpu_torch.tools.listen_clear")
    add_source_args(ap)
    ap.add_argument("--max-chunks", type=int, default=None)
    args = ap.parse_args(argv)

    from tetraear_tpu_torch.audio.accumulator import VoiceAccumulator
    from tetraear_tpu_torch.audio.export import write_wav
    from tetraear_tpu_torch.ui.cli import _device
    from tetraear_tpu_torch.utils.textscore import is_pure_ascii

    device = _device(args.device)
    log_dir = Path("logs")
    records_dir = Path("records")
    log_dir.mkdir(exist_ok=True)
    records_dir.mkdir(exist_ok=True)
    run = run_id()
    text_log = log_dir / f"clear_text_{run}.txt"

    loop = capture_loop(args, device, auto_decrypt=False)
    voice_acc = VoiceAccumulator()
    state = {"frames": 0, "texts": 0, "vframes": 0, "calls": 0,
             "last_status": time.time()}

    print("=" * 70)
    print("LISTENING FOR CLEAR TEXT & VOICE")
    print("=" * 70)
    print("Text: only pure ASCII; Voice: accumulating 3+ second calls")

    def save_clip(audio):
        state["calls"] += 1
        dur = len(audio) / 8000
        vfile = records_dir / f"clear_voice_{run}_{state['calls']:04d}.wav"
        write_wav(vfile, audio)
        print(f"\n[VOICE!] Saved {vfile.name} ({dur:.1f}s)")

    def on_frame(frame):
        state["frames"] += 1
        if frame.get("encrypted", True):
            return
        text = frame.get("decoded_text") or frame.get("sds_message") or ""
        if text and is_pure_ascii(text):
            state["texts"] += 1
            print(f"\n[TEXT!] Frame {state['frames']}: {text}")
            tf.write(f"Frame {state['frames']}: {text}\n")
            tf.flush()
        audio = voice_audio(loop, frame)
        if audio is not None:
            state["vframes"] += 1
            call_id = (frame.get("call_metadata") or {}).get(
                "talkgroup_id") or "unk"
            final = voice_acc.add(call_id, audio)
            if final is not None:
                save_clip(final)
        if time.time() - state["last_status"] > 30:
            print(f"[{datetime.now():%H:%M:%S}] {state['frames']} frames, "
                  f"{state['texts']} texts, {state['vframes']} vframes, "
                  f"{state['calls']} calls")
            state["last_status"] = time.time()

    loop.on_frame = on_frame
    with text_log.open("w") as tf:
        tf.write(f"=== CLEAR TEXT - {run} ===\n\n")
        try:
            loop.run(max_chunks=args.max_chunks)
        except KeyboardInterrupt:
            print("\nFinalizing...")
    for audio in voice_acc.finalize_all():
        save_clip(audio)
    print(f"\nDONE: {state['frames']} frames, {state['texts']} pure texts, "
          f"{state['calls']} voice calls")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
