"""Offline JSONL analysis: list unencrypted readable-text frames and their
hex payloads (the port's copy of tools/analyze_text.py; host only).

    python -m tetraear_tpu_torch.tools.analyze_text frames.jsonl [--limit N]
"""

from __future__ import annotations

import argparse


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m tetraear_tpu_torch.tools.analyze_text")
    ap.add_argument("frames_jsonl", type=str)
    ap.add_argument("--limit", type=int, default=20)
    args = ap.parse_args(argv)

    from tetraear_tpu_torch.io.recorder import read_jsonl_frames

    texts = []
    for frame in read_jsonl_frames(args.frames_jsonl):
        if not frame.get("encrypted", True):
            text = frame.get("decoded_text") or frame.get("sds_message", "")
            if text and not text.startswith("[BIN"):
                clean = (text.replace("[GSM7]", "").replace("[LOC]", "")
                         .strip())
                if len(clean) > 3:
                    texts.append({
                        "type": frame.get("type_name"),
                        "text": text,
                        "mac_pdu": frame.get("mac_pdu", {}) or {},
                        "frame_num": frame.get("number"),
                    })

    print(f"Found {len(texts)} unencrypted text frames\n")
    for i, t in enumerate(texts[:args.limit], 1):
        print(f"{i}. [{t['type']}] {t['text'][:80]}")

    print("\n\n=== Checking hex payloads ===")
    for i, t in enumerate(texts[:5], 1):
        if t["mac_pdu"].get("data"):
            print(f"\n{i}. Type: {t['type']}")
            print(f"   Text: {t['text']}")
            print(f"   Hex: {str(t['mac_pdu']['data'])[:50]}...")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
