"""Offline key brute-force over a recorded frames JSONL log (the port's
copy of tools/bruteforce_keys.py; host only).

Every key is run through the TEA engine (the native one from
native/teacrypt.cpp, built under build/native/, else crypto/tea.py)
against each encrypted frame's MAC payload, and the candidates are
ranked by SDS / text readability.

    python -m tetraear_tpu_torch.tools.bruteforce_keys frames.jsonl
        [-k keys.txt] [--max-frames N] [--top N]
"""

from __future__ import annotations

import argparse
from pathlib import Path


def load_key_file(path: str) -> list[str]:
    """The hex keys of an ALGORITHM:KEY_ID:HEX_KEY file."""
    keys = []
    for line in Path(path).read_text().splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split(":")
        if len(parts) == 3 and parts[2]:
            keys.append(parts[2])
    return keys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m tetraear_tpu_torch.tools.bruteforce_keys")
    ap.add_argument("frames_jsonl", type=str)
    ap.add_argument("-k", "--key-file", type=str, default="common_keys.txt")
    ap.add_argument("--max-frames", type=int, default=50)
    ap.add_argument("--top", type=int, default=10)
    args = ap.parse_args(argv)

    from tetraear_tpu_torch.crypto import native
    from tetraear_tpu_torch.crypto.keys import parse_user_keys
    from tetraear_tpu_torch.crypto.tea import TEADecryptor
    from tetraear_tpu_torch.io.recorder import read_jsonl_frames
    from tetraear_tpu_torch.protocol.parser import TetraProtocolParser
    from tetraear_tpu_torch.utils.textscore import score_text

    print("[*] Loading keys...")
    hex_keys = load_key_file(args.key_file)
    # parse_user_keys yields (algorithm, key_bytes); engines take (key, alg)
    pairs = [(key, alg) for alg, key in parse_user_keys(hex_keys)]
    print(f"[*] Loaded {len(hex_keys)} keys ({len(pairs)} alg-key pairs)")

    print("[*] Loading captured frames...")
    encrypted = []
    for frame in read_jsonl_frames(args.frames_jsonl):
        if frame.get("encrypted", False):
            data = (frame.get("mac_pdu") or {}).get("data")
            if data:
                encrypted.append(frame)
    print(f"[*] Found {len(encrypted)} encrypted frames")
    if not encrypted:
        print("[!] No encrypted frames to test")
        return 0
    test_frames = encrypted[:args.max_frames]
    print(f"[*] Testing on {len(test_frames)} frames")

    parser = TetraProtocolParser()
    results = []
    for fidx, frame in enumerate(test_frames):
        try:
            payload = bytes.fromhex(frame["mac_pdu"]["data"])
        except (TypeError, ValueError):
            continue
        if len(payload) < 8:
            continue
        if len(payload) % 8:
            payload += b"\x00" * (8 - len(payload) % 8)

        plains = native.bruteforce(pairs, payload)
        if plains is None:  # no native engine: crypto/tea.py
            plains = []
            for key, alg in pairs:
                try:
                    plains.append(TEADecryptor(key, alg).decrypt(payload))
                except ValueError:
                    plains.append(None)

        for (key, alg), plain in zip(pairs, plains):
            if plain is None:
                continue
            text = parser.parse_sds_data(plain)
            if not text or text.startswith("[BIN"):
                continue
            s = score_text(text)
            if s > 1.2:
                results.append({"key": key.hex().upper(), "alg": alg,
                                "frame": fidx, "text": text[:100], "score": s})
                print(f"[+] Candidate! score {s:.2f} key {key.hex()[:20]}... "
                      f"-> {text[:60]}")

    print(f"\n[*] Bruteforce complete: {len(results)} potential matches")
    if results:
        results.sort(key=lambda x: x["score"], reverse=True)
        print("\n[+] Best results:")
        for i, r in enumerate(results[:args.top], 1):
            print(f"{i}. score {r['score']:.2f} {r['alg']} key {r['key']}")
            print(f"   text: {r['text']}")
    else:
        print("[-] No clear text found with these keys")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
