"""Speech-codec quality meter: streaming and per-block round-trip metrics
of the spec-derived ACELP pair (the port's copy of tools/codec_quality.py;
host only).

Reports, per seed and aggregated:
  * corr      whole-signal Pearson correlation in vs out
  * segSNR    mean 30 ms segmental SNR (dB)
  * blk corr  per-240-sample-frame correlation: mean / p10 / min

Modes:
  * streaming      one scoder run -> one sdecoder run
  * per_block      one scoder run -> a fresh sdecoder process per 2-frame
                   serial block (the VoiceProcessor.decode_frame contract)
  * per_block_ctx  the same with the previous 4 blocks prepended as
                   warm-up, only the tail kept

--bin defaults to the port's codec: TETRAEAR_TPU_CODEC_DIR, else the
programs built from native/codec/ into build/codec/.

    python -m tetraear_tpu_torch.tools.codec_quality [--seeds 3,7,11]
        [--seconds 1.5] [--bin DIR] [--json]
"""
from __future__ import annotations

import argparse
import json
import subprocess
import tempfile
from pathlib import Path

import numpy as np

FRAME_N = 240
WORDS = 138            # (BFI + 137) int16 per speech frame


def seg_snr(x: np.ndarray, y: np.ndarray) -> float:
    n = min(len(x), len(y))
    x, y = x[:n].astype(float), y[:n].astype(float)
    seg = []
    for i in range(0, n - FRAME_N, FRAME_N):
        e = np.sum((x[i:i + FRAME_N] - y[i:i + FRAME_N]) ** 2) + 1e-12
        s = np.sum(x[i:i + FRAME_N] ** 2) + 1e-12
        seg.append(10 * np.log10(s / e))
    return float(np.mean(seg))


def block_corrs(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    n = min(len(x), len(y))
    out = []
    for i in range(0, n - FRAME_N + 1, FRAME_N):
        a = x[i:i + FRAME_N].astype(float)
        b = y[i:i + FRAME_N].astype(float)
        if a.std() < 1e-6 or b.std() < 1e-6:
            continue
        out.append(np.corrcoef(a, b)[0, 1])
    return np.asarray(out)


def run(exe: Path, inp: Path, outp: Path, cwd: Path) -> None:
    subprocess.run([str(exe), str(inp), str(outp)], check=True,
                   capture_output=True, timeout=60, cwd=cwd)


def measure(bin_dir: Path, pcm: np.ndarray, mode: str,
            tmp: Path, ctx_blocks: int = 4) -> dict:
    pcm_in = tmp / "in.pcm"
    pcm_in.write_bytes(pcm.tobytes())
    serial = tmp / "s.serial"
    run(bin_dir / "scoder", pcm_in, serial, tmp)
    if mode == "streaming":
        out_p = tmp / "out.pcm"
        run(bin_dir / "sdecoder", serial, out_p, tmp)
        out = np.fromfile(out_p, np.int16)
    else:
        # a fresh sdecoder process per 2-frame block; "per_block_ctx"
        # prepends the previous ctx_blocks serial blocks as warm-up and
        # keeps only the tail (the VoiceProcessor context-priming path)
        words = np.fromfile(serial, np.int16).reshape(-1, WORDS)
        pieces = []
        for i in range(0, len(words), 2):
            lo = max(0, i - 2 * ctx_blocks) if mode == "per_block_ctx" \
                else i
            blk = words[lo:i + 2]
            bp = tmp / "blk.serial"
            bp.write_bytes(blk.tobytes())
            op = tmp / "blk.pcm"
            run(bin_dir / "sdecoder", bp, op, tmp)
            dec = np.fromfile(op, np.int16)
            pieces.append(dec[(i - lo) * FRAME_N:])
        out = np.concatenate(pieces)
    bc = block_corrs(pcm, out)
    n = min(len(pcm), len(out))
    return {
        "corr": float(np.corrcoef(pcm[:n].astype(float),
                                  out[:n].astype(float))[0, 1]),
        "seg_snr_db": seg_snr(pcm, out),
        "blk_corr_mean": float(bc.mean()),
        "blk_corr_p10": float(np.percentile(bc, 10)),
        "blk_corr_min": float(bc.min()),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m tetraear_tpu_torch.tools.codec_quality")
    ap.add_argument("--seeds", default="3,7,11")
    ap.add_argument("--seconds", type=float, default=1.5)
    ap.add_argument("--bin", default=None,
                    help="the codec programs' directory (default: "
                         "TETRAEAR_TPU_CODEC_DIR, else the programs built "
                         "from native/codec into build/codec/)")
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)

    from tetraear_tpu_torch.utils.synth import make_test_speech
    if args.bin is None:
        from tetraear_tpu_torch.audio.voice import _default_codec_dir
        bin_dir = _default_codec_dir()
    else:
        bin_dir = Path(args.bin)
    seeds = [int(s) for s in args.seeds.split(",")]

    rows = []
    for seed in seeds:
        pcm = make_test_speech(args.seconds, seed=seed)
        for mode in ("streaming", "per_block", "per_block_ctx"):
            with tempfile.TemporaryDirectory() as td:
                m = measure(bin_dir, pcm, mode, Path(td))
            m.update(seed=seed, mode=mode)
            rows.append(m)

    if args.json:
        print(json.dumps(rows))
        return 0
    for mode in ("streaming", "per_block", "per_block_ctx"):
        sel = [r for r in rows if r["mode"] == mode]
        agg = {k: float(np.mean([r[k] for r in sel]))
               for k in ("corr", "seg_snr_db", "blk_corr_mean",
                         "blk_corr_p10", "blk_corr_min")}
        print(f"{mode:10s} corr={agg['corr']:.4f} "
              f"segSNR={agg['seg_snr_db']:.2f}dB "
              f"blk(mean/p10/min)={agg['blk_corr_mean']:.3f}/"
              f"{agg['blk_corr_p10']:.3f}/{agg['blk_corr_min']:.3f}")
        for r in sel:
            print(f"  seed {r['seed']}: corr={r['corr']:.4f} "
                  f"segSNR={r['seg_snr_db']:.2f} "
                  f"blk={r['blk_corr_mean']:.3f}/{r['blk_corr_p10']:.3f}/"
                  f"{r['blk_corr_min']:.3f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
