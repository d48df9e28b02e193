"""Kernel times of two checkouts of the port on one card, interleaved.

    python3 tools/kernel_ab.py --ref DIR [--pairs 1]   # DIR: another checkout
    python3 tools/kernel_ab.py --one                   # this process only

With --ref it runs `--one` in fresh processes in the order ref, this,
this, ref (--pairs times), each with PYTHONPATH set to its checkout (each
builds its own kernels into its checkout's build/kernels/), and prints
every time beside the card's name and power limit.  --one times, with
CUDA events over 20 launches after 3 warm-ups, at the bench block (n =
8,319,936 samples of complex noise, 2.4 MS/s): K1 bf16 at C2 = 32 (the
16-carrier frontend's weights, packed once) and on the full-band
filterbank (C2 = 192), K1 f32 and K4 dt (f32) at C2 = 32 with cuDNN's
f32 conv (TF32 off) of the same contraction, K4 dt on the filterbank at
the ragged n = 1,000,007 (each K4 dt also as its error against the
plain version, x max|plain|), K4 dt_bf16 at C2 = 32 (packed once where
the checkout packs K4), and K5 on carrier_grid(16) with the staged
frontend's taps at 2.4 MS/s (121) and at 8 MS/s (397 taps, D = 33, on
the same samples); it prints one JSON line of milliseconds.  A checkout
given by --ref needs only the port's package (e.g. a git archive of
another commit).
"""

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
BENCH_N = 8_319_936
RAGGED_N = 1_000_007


def _time_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _rel_err(got, want) -> float:
    return ((got - want).abs().max() / want.abs().max()).item()


def one() -> dict:
    """The times of the port on sys.path, in ms."""
    import torch
    from tetraear_tpu_torch.config import ReceiverConfig
    from tetraear_tpu_torch.models.multicarrier import (
        MulticarrierFrontend, PfbMulticarrierFrontend)
    from tetraear_tpu_torch.models.realpair import staged_state
    from tetraear_tpu_torch.ops.channelizer import carrier_grid
    from tetraear_tpu_torch.ops.kernels import fused_channelize as k5
    from tetraear_tpu_torch.ops.kernels import s2d_conv as kc
    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(2)
    x = torch.randn(BENCH_N, dtype=torch.complex64, device=dev,
                    generator=gen) * 0.1
    t = {}
    mc = MulticarrierFrontend.from_offsets(carrier_grid(16), device=dev,
                                           conv="s2d")
    k2, gc, L, decim = mc.kernel_s2d, mc.gc, mc.L, mc.decim
    tc = kc.tc_pack_k1(k2)
    t["k1_bf16"] = _time_ms(torch, lambda: kc.s2d_conv(
        x, k2, gc, L, decim, bf16=True, tc=tc))
    # the f32 routes: K1, K4 dt at the bench shape and on the full-band
    # filterbank at a ragged n, K4's error against its plain version
    # (x max|plain|), and cuDNN's f32 conv of the same contraction
    torch.backends.cudnn.allow_tf32 = False
    t["k1_f32"] = _time_ms(torch, lambda: kc.s2d_conv(x, k2, gc, L, decim))
    t["k4_dt"] = _time_ms(torch, lambda: kc.s2d_conv_dt(
        x, k2, gc, L, decim))
    t["k4_dt_err"] = _rel_err(kc.s2d_conv_dt(x, k2, gc, L, decim),
                              kc.s2d_conv_plain(x, k2, gc, L, decim))
    m_out = -(-BENCH_N // decim)
    total = max((m_out + k2.shape[-1] - 1) * decim,
                -(-(L - 1 - gc + BENCH_N) // decim) * decim)
    xv = kc._x2_view(x, L - 1 - gc, total, decim).contiguous()
    t["cudnn_f32"] = _time_ms(torch, lambda: torch.nn.functional.conv1d(
        xv, k2))
    del xv
    kw = {"tc": kc.tc_pack_dt(k2)} if hasattr(kc, "tc_pack_dt") else {}
    t["k4_dt_bf16"] = _time_ms(torch, lambda: kc.s2d_conv_dt(
        x, k2, gc, L, decim, bf16=True, **kw))
    pfb = PfbMulticarrierFrontend.from_config(device=dev, conv="s2d")
    tcp = kc.tc_pack_k1(pfb.kernel_s2d)
    xr = x[:RAGGED_N]
    kp = pfb.kernel_s2d
    t["k4_dt_full_band_ragged"] = _time_ms(torch, lambda: kc.s2d_conv_dt(
        xr, kp, 0, pfb.L, pfb.decim))
    t["k4_dt_full_band_ragged_err"] = _rel_err(
        kc.s2d_conv_dt(xr, kp, 0, pfb.L, pfb.decim),
        kc.s2d_conv_plain(xr, kp, 0, pfb.L, pfb.decim))
    t["k1_bf16_full_band"] = _time_ms(torch, lambda: kc.s2d_conv(
        x, pfb.kernel_s2d, 0, pfb.L, pfb.decim, bf16=True, tc=tcp))
    state = staged_state(carrier_grid(16))
    offs = torch.as_tensor(state.offsets_hz, device=dev)
    taps = torch.as_tensor(state.taps_d, device=dev)
    t["k5"] = _time_ms(torch, lambda: k5.fused_channelize(
        x, offs, state.sample_rate_hz, state.decim, taps))
    st8 = staged_state(carrier_grid(16), ReceiverConfig(sample_rate_hz=8e6))
    offs8 = torch.as_tensor(st8.offsets_hz, device=dev)
    taps8 = torch.as_tensor(st8.taps_d, device=dev)
    t["k5_8msps"] = _time_ms(torch, lambda: k5.fused_channelize(
        x, offs8, st8.sample_rate_hz, st8.decim, taps8))
    return t


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ref", type=Path, help="the other checkout")
    ap.add_argument("--pairs", type=int, default=1)
    ap.add_argument("--one", action="store_true")
    args = ap.parse_args()
    if args.one:
        if "PYTHONPATH" not in os.environ:
            sys.path.insert(0, str(REPO))
        print(json.dumps(one()))
        return 0
    if args.ref is None:
        ap.error("--ref DIR or --one")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    runs = {"ref": [], "this": []}
    for _ in range(args.pairs):
        for tag in ("ref", "this", "this", "ref"):
            root = args.ref.resolve() if tag == "ref" else REPO
            env = dict(os.environ, PYTHONPATH=str(root))
            out = subprocess.run([sys.executable, __file__, "--one"],
                                 cwd=root, env=env, capture_output=True,
                                 text=True)
            if out.returncode != 0:
                print(out.stderr[-3000:], file=sys.stderr)
                return 1
            runs[tag].append(json.loads(out.stdout.strip().splitlines()[-1]))
            print(f"[ab] {card}: {tag} ({root}): {runs[tag][-1]}",
                  flush=True)
    for name in runs["this"][0]:
        ref = [r[name] for r in runs["ref"]]
        new = [r[name] for r in runs["this"]]
        fmt, unit = ((".3e", " x max|plain|") if name.endswith("_err")
                     else (".4f", " ms"))
        print(f"[ab] {card}: {name}: ref "
              f"{' / '.join(format(v, fmt) for v in ref)}{unit}, this "
              f"{' / '.join(format(v, fmt) for v in new)}{unit}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
