"""Drive the PyTorch/CUDA port once on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases (each prints its results; the first failure exits nonzero):
  1. device   refuse to run without CUDA; print the card's name and
              power limit as nvidia-smi reports them
  2. build    compile K1 (tetraear_tpu_torch/csrc/s2d_conv.cu) with nvcc
              for sm_90a; print the build time and ptxas's report
  3. kernel   K1 against its plain F.conv1d version on the card, f32 and
              bf16, at C2 = 32 with the bench's n = 8,319,936 and at
              C2 = 192 with a ragged n = 1,000,007
  4. decode   the main path through the entry point a user calls:
              `tetraear_tpu_torch.ui.cli.main(["decode", f, "--carriers",
              "16", "--conv", "pallas_bf16"])` on a planted three-carrier
              burst signal; every planted SDS text must come back on its
              grid index, and K1 must have launched in that run
  5. timing   at the bench shape (16 carriers, n = 8,319,936, K = 64,
              threshold 0.80): K1 against the plain conv, the frontend's
              stages and its end-to-end rate, with CUDA events

The line before the last is a JSON object with each kernel's route,
source, launches in phase 4, error and times; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

BENCH_N = 8_319_936          # bench.py's n per block (16 carriers)
RAGGED_N = 1_000_007
TOL = 4e-6                   # x max|plain|: f32 sum order only
PLANTED = (3, 8, 12)         # grid indices of carrier_grid(16)


def fail(phase: str, msg: str) -> None:
    print(f"[{phase}] FAIL: {msg}", flush=True)
    sys.exit(1)


def phase_device():
    import torch
    if not torch.cuda.is_available():
        fail("device", "torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    if smi.returncode != 0:
        fail("device", f"nvidia-smi exited {smi.returncode}: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    print(f"[device] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s), using "
          f"{torch.cuda.get_device_name(0)}")
    return card


def phase_build():
    from tetraear_tpu_torch.ops.kernels import KernelBuildError, build
    t0 = time.perf_counter()
    try:
        _lib, report = build("s2d_conv")
    except KernelBuildError as e:
        fail("build", str(e))
    print(f"[build] s2d_conv ready in {time.perf_counter() - t0:.1f} s")
    for line in report.strip().splitlines():
        print(f"[build]   {line}")


def _case(num_carriers: int, n: int, seed: int, device):
    """(x, kernel, gc, L, D) on the card: complex noise * 0.1 and the
    composite kernel of carrier_grid(num_carriers)."""
    import numpy as np
    import torch
    from tetraear_tpu.config import ReceiverConfig
    from tetraear_tpu_torch.ops import fused
    from tetraear_tpu_torch.ops.channelizer import carrier_grid
    cfg = ReceiverConfig()
    cutoff = (cfg.channel_bandwidth_hz / 2) / (cfg.intermediate_rate_hz / 2)
    kernel, gc, _rot = fused.fused_kernel(
        np.asarray(carrier_grid(num_carriers), np.float64),
        cfg.sample_rate_hz, cfg.decimation_factor,
        cfg.decim_fir_taps_per_phase, cfg.channel_fir_taps, cutoff)
    k2 = torch.as_tensor(fused.s2d_kernel(kernel, cfg.decimation_factor),
                         device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(n, dtype=torch.complex64, device=device,
                    generator=gen) * 0.1
    return x, k2, gc, kernel.shape[-1], cfg.decimation_factor


def phase_kernel(device) -> float:
    import torch
    from tetraear_tpu_torch.ops.kernels import s2d_conv as k1
    worst = 0.0
    for num_carriers, n in ((16, BENCH_N), (96, RAGGED_N)):
        x, k2, gc, L, decim = _case(num_carriers, n, 1, device)
        for bf16 in (False, True):
            before = k1.LAUNCHES
            got = k1.s2d_conv(x, k2, gc, L, decim, bf16=bf16)
            torch.cuda.synchronize()
            if k1.LAUNCHES != before + 1:
                fail("kernel", "the launch counter did not move")
            want = k1.s2d_conv_plain(x, k2, gc, L, decim, bf16=bf16)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            scale = want.abs().max().item()
            ok = got.shape == want.shape and err <= TOL * scale
            print(f"[kernel] C2={k2.shape[0]} n={n} "
                  f"{'bf16' if bf16 else 'f32'}: max|K1-plain| = {err:.3e}, "
                  f"max|plain| = {scale:.4f}, bound {TOL} x max|plain| = "
                  f"{TOL * scale:.3e}: {'ok' if ok else 'FAIL'}")
            if not ok:
                fail("kernel", f"K1 disagrees with its plain version "
                               f"(shape {tuple(got.shape)} vs "
                               f"{tuple(want.shape)})")
            worst = max(worst, err)
    return worst


def phase_decode() -> int:
    import torch  # noqa: F401  (the CLI picks cuda by default)
    from tetraear_tpu.io.replay import save_iq
    from tetraear_tpu_torch.ops.kernels import s2d_conv as k1
    from tetraear_tpu_torch.ui.cli import main
    from tetraear_tpu_torch.utils.synth import planted_wideband
    x, want = planted_wideband(PLANTED)
    with tempfile.TemporaryDirectory() as tmp:
        iq = Path(tmp) / "planted.cf32"
        out = Path(tmp) / "planted_frames.jsonl"
        save_iq(iq, x)
        k1.LAUNCHES = 0
        rc = main(["decode", str(iq), "--carriers", "16", "--conv",
                   "pallas_bf16", "-o", str(out)])
        launches = k1.LAUNCHES
        got = {}
        for line in out.read_text().splitlines():
            frame = json.loads(line)
            got.setdefault(frame["carrier"], set()).add(
                frame.get("sds_message"))
    print(f"[decode] cli exit {rc}, K1 launches {launches}")
    if rc != 0:
        fail("decode", f"cli exited {rc}")
    for k, text in want.items():
        hit = text in got.get(k, set())
        print(f"[decode] carrier {k}: {text!r} {'found' if hit else 'MISSING'}")
        if not hit:
            fail("decode", f"{text!r} not decoded on grid index {k}")
    if launches == 0:
        fail("decode", "the main path never launched K1")
    return launches


def _time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    import torch
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


def _device_busy_ms(fn, iters: int = 3) -> tuple:
    """Kernel time per call summed from a torch.profiler trace, and the
    kernels by device time; (None, []) if the trace holds no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    kernels = [(e.key, e.self_device_time_total / 1e3 / iters)
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels.sort(key=lambda kv: -kv[1])
    busy = sum(ms for _, ms in kernels)
    return (busy or None), kernels[:12]


def phase_timing(device, card: str) -> dict:
    import torch
    from tetraear_tpu_torch.models.multicarrier import (
        MulticarrierDecoder, MulticarrierFrontend, extract_candidates)
    from tetraear_tpu_torch.models.realpair import _demod_from_pair
    from tetraear_tpu_torch.ops.channelizer import carrier_grid
    from tetraear_tpu_torch.ops.kernels import s2d_conv as k1
    x, k2, gc, L, decim = _case(16, BENCH_N, 2, device)
    t = {}
    # plain, kernel, kernel, plain: the order evens out drift on the card
    for bf16 in (True, False):
        tag = "bf16" if bf16 else "f32"
        p1 = _time_ms(lambda: k1.s2d_conv_plain(x, k2, gc, L, decim,
                                                bf16=bf16))
        c1 = _time_ms(lambda: k1.s2d_conv(x, k2, gc, L, decim, bf16=bf16))
        c2 = _time_ms(lambda: k1.s2d_conv(x, k2, gc, L, decim, bf16=bf16))
        p2 = _time_ms(lambda: k1.s2d_conv_plain(x, k2, gc, L, decim,
                                                bf16=bf16))
        t[f"k1_{tag}"] = (c1 + c2) / 2
        t[f"plain_{tag}"] = (p1 + p2) / 2
        flops = 2 * k2.shape[0] * k2.shape[1] * k2.shape[2] * (-(-BENCH_N // decim))
        print(f"[timing] {card}: K1 {tag} {c1:.3f} / {c2:.3f} ms "
              f"({flops / t[f'k1_{tag}'] / 1e9:.1f} TFLOP/s), plain "
              f"F.conv1d {p1:.3f} / {p2:.3f} ms")

    mc = MulticarrierFrontend.from_offsets(carrier_grid(16), device=device,
                                           num_candidates=64, threshold=0.80,
                                           conv="pallas_bf16")
    yr, yi = mc.channelize(x)
    res = _demod_from_pair(yr, yi, mc.sps, z_rot=(mc.z_cos, mc.z_sin))
    valid_bits = (res.count - 1).clamp_min(0) * 2
    t["conv"] = _time_ms(lambda: mc.channelize(x))
    t["tail"] = _time_ms(lambda: _demod_from_pair(
        yr, yi, mc.sps, z_rot=(mc.z_cos, mc.z_sin)))
    t["candidates"] = _time_ms(lambda: extract_candidates(
        res.bits, res.sync_corr, valid_bits, 64, 0.80, mc.crc_a, mc.crc_c0))
    torch.cuda.reset_peak_memory_stats()
    t["frontend"] = _time_ms(lambda: mc(x))
    peak = torch.cuda.max_memory_allocated() / 2**20
    result = mc(x)
    dec = MulticarrierDecoder(16)
    t0 = time.perf_counter()
    frames = dec.decode(result)
    t["host_decode"] = (time.perf_counter() - t0) * 1e3
    busy_ms, top = _device_busy_ms(lambda: mc(x))
    if busy_ms is None:
        print("[timing] device busy share: not measured (the profiler "
              "recorded no device time)")
    else:
        print(f"[timing] {card}: device busy {busy_ms:.3f} ms of the "
              f"{t['frontend']:.3f} ms block "
              f"({busy_ms / t['frontend']:.1%}); by kernel:")
        for name, ms in top:
            print(f"[timing]   {ms:8.3f} ms  {name[:90]}")
    rate = BENCH_N / (t["frontend"] / 1e3)
    print(f"[timing] {card}: frontend (pallas_bf16, 16 carriers, "
          f"n={BENCH_N}, K=64) {t['frontend']:.3f} ms/block = "
          f"{rate:,.0f} samples/s; conv {t['conv']:.3f} ms, demod tail "
          f"{t['tail']:.3f} ms, candidates {t['candidates']:.3f} ms; host "
          f"decode {t['host_decode']:.1f} ms ({sum(map(len, frames))} "
          f"frames on noise); peak device memory {peak:.0f} MiB")
    return t


def main() -> int:
    card = phase_device()
    import torch
    try:
        import tetraear_tpu_torch  # noqa: F401
    except ImportError as e:
        fail("device", f"the port is not importable here: {e}")
    device = torch.device("cuda:0")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    phase_build()
    err = phase_kernel(device)
    launches = phase_decode()
    t = phase_timing(device, card)
    print(card)
    print(json.dumps({"kernels": [{
        "name": "s2d_conv",
        "route": "cuda",
        "source": "tetraear_tpu_torch/csrc/s2d_conv.cu",
        "replaces": "tetraear_tpu/ops/pallas/s2d_conv.py:71",
        "launches": launches,
        "max_abs_err": err,
        "ms": t["k1_bf16"],
        "plain_ms": t["plain_bf16"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
