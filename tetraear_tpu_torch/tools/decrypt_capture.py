"""Live capture with common-key auto-decryption and readability triage
(the port's copy of tools/decrypt_capture.py, the receive loop on
--device).

Every decoded frame goes to logs/decrypt_<run>.jsonl; decrypted or clear
frames whose text scores as readable are echoed and appended to
logs/readable_<run>.txt, under the working directory.

    python -m tetraear_tpu_torch.tools.decrypt_capture
        [--iq-file f | --synthetic] [-f MHz] [-s MS/s] [-k keys.txt]
        [--max-chunks N] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
from pathlib import Path

from tetraear_tpu_torch.tools._capture import (add_source_args, capture_loop,
                                               run_id)


def load_keys(path: str) -> list[str]:
    """The hex keys of an ALGORITHM:KEY_ID:HEX_KEY file (odd lengths padded
    with a 0), none when it does not exist."""
    keys = []
    p = Path(path)
    if not p.exists():
        return keys
    for line in p.read_text().splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split(":")
        if len(parts) == 3:
            key_hex = parts[2].strip()
            if len(key_hex) % 2 == 1:
                key_hex += "0"
            keys.append(key_hex)
    return keys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m tetraear_tpu_torch.tools.decrypt_capture")
    add_source_args(ap)
    ap.add_argument("-k", "--key-file", type=str, default="common_keys.txt")
    ap.add_argument("--max-chunks", type=int, default=None)
    args = ap.parse_args(argv)

    from tetraear_tpu_torch.io.recorder import JsonlFrameRecorder
    from tetraear_tpu_torch.ui.cli import _device
    from tetraear_tpu_torch.utils.textscore import score_readability

    device = _device(args.device)
    log_dir = Path("logs")
    log_dir.mkdir(exist_ok=True)
    run = run_id()
    frames_log = log_dir / f"decrypt_{run}.jsonl"
    found_log = log_dir / f"readable_{run}.txt"

    print("[*] Loading common keys...")
    keys = load_keys(args.key_file)
    print(f"[*] Loaded {len(keys)} keys")

    loop = capture_loop(args, device, auto_decrypt=True,
                        encryption_keys=keys)

    state = {"frames": 0, "readable": 0}
    rec = JsonlFrameRecorder(frames_log)
    ff = found_log.open("w")

    def on_frame(frame):
        state["frames"] += 1
        rec.write(frame)
        text = frame.get("decoded_text") or frame.get("sds_message") or ""
        if text:
            s = score_readability(text)
            if s >= 2.0:
                state["readable"] += 1
                tag = "[DEC]" if frame.get("decrypted") else "[CLR]"
                line = (f"{tag} frame {state['frames']} "
                        f"score {s:.2f}: {text[:100]}")
                print(line)
                ff.write(line + "\n")
                ff.flush()

    loop.on_frame = on_frame
    try:
        loop.run(max_chunks=args.max_chunks)
    except KeyboardInterrupt:
        pass
    finally:
        rec.close()
        ff.close()
    print(f"[DONE] {state['frames']} frames, {state['readable']} readable "
          f"-> {frames_log}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
