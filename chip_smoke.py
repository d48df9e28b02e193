"""Drive the PyTorch/CUDA port once on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases (each prints its results; the first failure exits nonzero):
  1. device   refuse to run without CUDA; print the card's name and
              power limit as nvidia-smi reports them
  2. build    compile K1 / K1-of (tetraear_tpu_torch/csrc/s2d_conv.cu) and
              K3 (csrc/s2d_conv_db.cu) with nvcc for sm_90a, one nvcc per
              source, both at once; print the build times and ptxas's
              report
  3. kernel   each kernel against its plain PyTorch version on the card:
              K1, f32 and bf16, at C2 = 32 with the bench's n = 8,319,936,
              at C2 = 192 with a ragged n = 1,000,007, and on the full-band
              filterbank kernel (C2 = 192, gc = 0) at n = 8,319,936;
              K3 at the 16-carrier bench shape, on the filterbank kernel
              at the bench n and the ragged n, and on inputs that start
              one sample into their storage (off the 16-byte grid of its
              async copies), each bit-equal to K1 f32; K1-of at
              fold 4 (f32 and bf16) at the bench shape and folds 6 and 1
              at the ragged n
  4. decode   the main paths through the entry points a user calls, each
              on a planted signal, every launch count set to 0 just before
              and read just after: `tetraear_tpu_torch.ui.cli.main(
              ["decode", f, "--carriers", "16", "--conv", "pallas_bf16"])`
              and the same with "--pfb" (all 96 channels; texts on their
              fftfreq channels), both launching K1;
              `PfbMulticarrierFrontend(conv="pallas_db")` (K3) and
              `MulticarrierFrontend(conv="pallas_of4_bf16")` (K1-of)
              through `MulticarrierDecoder`.  Every planted SDS text must
              come back on its channel, and each path's kernel must have
              launched
  5. timing   at n = 8,319,936, K = 64, threshold 0.80, with CUDA events:
              K1, K3 and K1-of (fold 4) against their plain versions and
              K1, at C2 = 32 and (K1, K3) on the filterbank kernel, and
              the 16-carrier (pallas_bf16) and full-band (pallas_bf16,
              pallas_db) frontends' stages, end-to-end rate, device busy
              share (torch.profiler), peak memory and host decode

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

BENCH_N = 8_319_936          # bench.py's n per block
RAGGED_N = 1_000_007
TOL = 4e-6                   # x max|plain|: f32 sum order only
BF16_TOL = 1e-2              # x max|f32 plain|: bf16 operand rounding
PLANTED = (3, 8, 12)         # grid indices of carrier_grid(16)
KERNELS = {                  # wrapper -> (source, TPU kernel it replaces)
    "s2d_conv": ("tetraear_tpu_torch/csrc/s2d_conv.cu",
                 "tetraear_tpu/ops/pallas/s2d_conv.py:71"),
    "s2d_conv_of": ("tetraear_tpu_torch/csrc/s2d_conv.cu",
                    "tetraear_tpu/ops/pallas/s2d_conv.py:371"),
    "s2d_conv_db": ("tetraear_tpu_torch/csrc/s2d_conv_db.cu",
                    "tetraear_tpu/ops/pallas/s2d_conv.py:162"),
}


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
    from concurrent.futures import ThreadPoolExecutor
    from tetraear_tpu_torch.ops.kernels import KernelBuildError, build
    sources = ("s2d_conv", "s2d_conv_db")
    t0 = time.perf_counter()
    try:
        with ThreadPoolExecutor(len(sources)) as pool:
            reports = list(pool.map(lambda s: build(s)[1], sources))
    except KernelBuildError as e:
        fail("build", str(e))
    print(f"[build] {', '.join(sources)} ready in "
          f"{time.perf_counter() - t0:.1f} s")
    for report in reports:
        for line in report.strip().splitlines():
            print(f"[build]   {line}")


def _case(num_carriers, n: int, seed: int, device):
    """(x, s2d kernel, gc, L, D) on the card: complex noise * 0.1 and the
    frontend's composite kernel for carrier_grid(num_carriers), or the
    full-band filterbank's for "pfb"."""
    import torch
    from tetraear_tpu_torch.models.multicarrier import (
        MulticarrierFrontend, PfbMulticarrierFrontend)
    from tetraear_tpu_torch.ops.channelizer import carrier_grid
    if num_carriers == "pfb":
        mc = PfbMulticarrierFrontend.from_config(device=device, conv="s2d")
    else:
        mc = MulticarrierFrontend.from_offsets(carrier_grid(num_carriers),
                                               device=device, conv="s2d")
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(n, dtype=torch.complex64, device=device,
                    generator=gen) * 0.1
    return x, mc.kernel_s2d, mc.gc, mc.L, mc.decim


def _held(tag: str, name: str, got, want, bound: float) -> float:
    """max|got - want| within bound x max|want|, or the run fails."""
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    ok = got.shape == want.shape and err <= bound * scale
    print(f"[kernel] {tag}: max|{name}-plain| = {err:.3e}, max|plain| = "
          f"{scale:.4f}, bound {bound} x max|plain| = {bound * scale:.3e}: "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        fail("kernel", f"{name} disagrees with its plain version "
                       f"(shape {tuple(got.shape)} vs {tuple(want.shape)})")
    return err


def _launched(wrapper: str, fn):
    """fn() with one launch of `wrapper` counted, synchronized."""
    import torch
    from tetraear_tpu_torch.ops.kernels import s2d_conv as kc
    before = kc.LAUNCHES[wrapper]
    out = fn()
    torch.cuda.synchronize()
    if kc.LAUNCHES[wrapper] != before + 1:
        fail("kernel", f"the {wrapper} launch counter did not move")
    return out


def phase_kernel(device) -> dict:
    import torch
    from tetraear_tpu_torch.ops import fused
    from tetraear_tpu_torch.ops.kernels import s2d_conv as kc
    worst = dict.fromkeys(KERNELS, 0.0)
    # K1 at both widths and on the filterbank kernel (gc = 0: pad_l =
    # 767, the first ~77 windows straddle the left zero pad)
    for num_carriers, n in ((16, BENCH_N), (96, RAGGED_N), ("pfb", BENCH_N)):
        x, k2, gc, L, decim = _case(num_carriers, n, 1, device)
        for bf16 in (False, True):
            got = _launched("s2d_conv", lambda: kc.s2d_conv(
                x, k2, gc, L, decim, bf16=bf16))
            want = kc.s2d_conv_plain(x, k2, gc, L, decim, bf16=bf16)
            tag = (f"K1 {num_carriers} C2={k2.shape[0]} gc={gc} n={n} "
                   f"{'bf16' if bf16 else 'f32'}")
            worst["s2d_conv"] = max(worst["s2d_conv"],
                                    _held(tag, "K1", got, want, TOL))
        del x, got, want
    # K3: bit-equal to K1 f32, so within the sum-order bound of plain.
    # start = 1 begins the input one sample into its storage, off the
    # 16-byte grid of K3's async copies; the full-band bench shape is the
    # one the timing phase reports
    for num_carriers, n, start in ((16, BENCH_N, 0), (16, RAGGED_N, 1),
                                   ("pfb", RAGGED_N, 0), ("pfb", RAGGED_N, 1),
                                   ("pfb", BENCH_N, 0)):
        x, k2, gc, L, decim = _case(num_carriers, n + start, 2, device)
        x = x[start:]
        got = _launched("s2d_conv_db",
                        lambda: kc.s2d_conv_db(x, k2, gc, L, decim))
        k1 = kc.s2d_conv(x, k2, gc, L, decim)
        same = torch.equal(got, k1)
        tag = f"K3 {num_carriers} C2={k2.shape[0]} gc={gc} n={n} start={start}"
        print(f"[kernel] {tag}: bit-equal to K1 f32: "
              f"{'yes' if same else 'NO'}")
        if not same:
            fail("kernel", f"{tag} is not bit-equal to K1 "
                 f"({(got - k1).abs().max().item():.3e} apart)")
        want = kc.s2d_conv_plain(x, k2, gc, L, decim)
        worst["s2d_conv_db"] = max(worst["s2d_conv_db"],
                                   _held(tag, "K3", got, want, TOL))
        del x, got, want, k1
    # K1-of against the folded plain version (f32 sum order for both
    # operand types) and, for bf16, against the f32 result
    for fold, n in ((4, BENCH_N), (6, RAGGED_N), (1, RAGGED_N)):
        x, k2, gc, L, decim = _case(16, n, 3, device)
        k_of = torch.as_tensor(fused.fold_s2d_kernel(k2.cpu().numpy(), fold),
                               device=device)
        f32 = kc.s2d_conv_of_plain(x, k_of, gc, L, decim, fold)
        for bf16 in (False, True):
            got = _launched("s2d_conv_of", lambda: kc.s2d_conv_of(
                x, k_of, gc, L, decim, fold, bf16=bf16))
            want = kc.s2d_conv_of_plain(x, k_of, gc, L, decim, fold,
                                        bf16=bf16)
            tag = f"K1-of fold={fold} n={n} {'bf16' if bf16 else 'f32'}"
            worst["s2d_conv_of"] = max(worst["s2d_conv_of"],
                                       _held(tag, "K1-of", got, want, TOL))
            if bf16:
                _held(tag + " vs f32", "K1-of", got, f32, BF16_TOL)
        del x, got, want, f32
    return worst


def _texts(frames_by_channel) -> dict:
    got = {}
    for frames in frames_by_channel:
        for frame in frames:
            got.setdefault(frame["carrier"], set()).add(
                frame.get("sds_message"))
    return got


def _check_texts(tag: str, want: dict, got: dict) -> None:
    for k, text in want.items():
        hit = text in got.get(k, set())
        print(f"[decode] {tag} channel {k}: {text!r} "
              f"{'found' if hit else 'MISSING'}")
        if not hit:
            fail("decode", f"{tag}: {text!r} not decoded on channel {k}")


def _path(tag: str, wrapper: str, run) -> dict:
    """Runs one main path with every launch count set to 0 just before
    and read just after; the path's kernel must have launched."""
    from tetraear_tpu_torch.ops.kernels import s2d_conv as kc
    for name in kc.LAUNCHES:
        kc.LAUNCHES[name] = 0
    run()
    counts = dict(kc.LAUNCHES)
    print(f"[decode] {tag}: launches {counts}")
    if counts[wrapper] == 0:
        fail("decode", f"{tag} never launched {wrapper}")
    return counts


def _cli_run(tag: str, argv: list, x, want: dict) -> None:
    import numpy as np
    from tetraear_tpu_torch.ui.cli import main
    with tempfile.TemporaryDirectory() as tmp:
        iq = Path(tmp) / "planted.cf32"
        out = Path(tmp) / "planted_frames.jsonl"
        # .cf32: interleaved float32 I/Q
        np.asarray(x, np.complex64).view(np.float32).tofile(iq)
        rc = main(["decode", str(iq), *argv, "-o", str(out)])
        got = _texts([map(json.loads, out.read_text().splitlines())])
    print(f"[decode] {tag}: cli exit {rc}")
    if rc != 0:
        fail("decode", f"{tag}: cli exited {rc}")
    _check_texts(tag, want, got)


def phase_decode(device) -> dict:
    from tetraear_tpu_torch.models.multicarrier import (
        MulticarrierDecoder, MulticarrierFrontend, PfbMulticarrierFrontend)
    from tetraear_tpu_torch.ops.channelizer import carrier_grid
    from tetraear_tpu_torch.utils.synth import planted_pfb, planted_wideband
    x16, want16 = planted_wideband(PLANTED)
    xpfb, wantpfb = planted_pfb()
    launches = dict.fromkeys(KERNELS, 0)

    def add(counts):
        for name, n in counts.items():
            launches[name] += n

    add(_path("cli 16 carriers pallas_bf16", "s2d_conv", lambda: _cli_run(
        "cli 16 carriers pallas_bf16",
        ["--carriers", "16", "--conv", "pallas_bf16"], x16, want16)))
    add(_path("cli --pfb pallas_bf16", "s2d_conv", lambda: _cli_run(
        "cli --pfb pallas_bf16",
        ["--carriers", "16", "--pfb", "--conv", "pallas_bf16"], xpfb,
        wantpfb)))

    def module_run(tag, mc, x, num_channels, want):
        frames = MulticarrierDecoder(num_channels).decode(mc(x))
        _check_texts(tag, want, _texts(frames))

    pfb = PfbMulticarrierFrontend.from_config(device=device,
                                              conv="pallas_db")
    add(_path("PfbMulticarrierFrontend pallas_db", "s2d_conv_db",
              lambda: module_run("pfb pallas_db", pfb, xpfb, 96, wantpfb)))
    mc = MulticarrierFrontend.from_offsets(carrier_grid(16), device=device,
                                           conv="pallas_of4_bf16")
    add(_path("MulticarrierFrontend pallas_of4_bf16", "s2d_conv_of",
              lambda: module_run("16 carriers pallas_of4_bf16", mc, x16, 16,
                                 want16)))
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


def _pair_ms(kernel_fn, plain_fn, iters: int = 10) -> tuple:
    """(kernel ms, plain ms), timed plain, kernel, kernel, plain: the
    order evens out drift on the card."""
    p1 = _time_ms(plain_fn, iters)
    c1 = _time_ms(kernel_fn, iters)
    c2 = _time_ms(kernel_fn, iters)
    p2 = _time_ms(plain_fn, iters)
    return (c1 + c2) / 2, (p1 + p2) / 2, (c1, c2, p1, p2)


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


def _frontend_timing(tag: str, mc, x, card: str, iters: int) -> dict:
    """Stage times (each stage alone), end to end, busy share, peak
    memory and host decode of one frontend on one block."""
    import torch
    from tetraear_tpu_torch.models.multicarrier import (MulticarrierDecoder,
                                                        extract_candidates)
    from tetraear_tpu_torch.models.realpair import _demod_from_pair
    t = {}
    yr, yi = mc.channelize(x)
    res = _demod_from_pair(yr, yi, mc.sps, z_rot=(mc.z_cos, mc.z_sin))
    valid_bits = (res.count - 1).clamp_min(0) * 2
    t["conv"] = _time_ms(lambda: mc.channelize(x), iters)
    t["tail"] = _time_ms(lambda: _demod_from_pair(
        yr, yi, mc.sps, z_rot=(mc.z_cos, mc.z_sin)), iters)
    t["candidates"] = _time_ms(lambda: extract_candidates(
        res.bits, res.sync_corr, valid_bits, mc.num_candidates,
        mc.threshold, mc.crc_a, mc.crc_c0), iters)
    del yr, yi, res
    torch.cuda.reset_peak_memory_stats()
    t["frontend"] = _time_ms(lambda: mc(x), iters)
    peak = torch.cuda.max_memory_allocated() / 2**20
    result = mc(x)
    rows = result.bits.shape[0]
    dec = MulticarrierDecoder(rows)
    t0 = time.perf_counter()
    frames = dec.decode(result)
    t["host_decode"] = (time.perf_counter() - t0) * 1e3
    busy_ms, top = _device_busy_ms(lambda: mc(x))
    if busy_ms is None:
        print(f"[timing] {tag}: device busy share: not measured (the "
              "profiler recorded no device time)")
    else:
        print(f"[timing] {card}: {tag}: device busy {busy_ms:.3f} ms of the "
              f"{t['frontend']:.3f} ms block "
              f"({busy_ms / t['frontend']:.1%}); by kernel:")
        for name, ms in top:
            print(f"[timing]   {ms:8.3f} ms  {name[:90]}")
    rate = x.shape[0] / (t["frontend"] / 1e3)
    print(f"[timing] {card}: {tag} (n={x.shape[0]}, "
          f"K={mc.num_candidates}) {t['frontend']:.3f} ms/block = "
          f"{rate:,.0f} samples/s; conv {t['conv']:.3f} ms, demod tail "
          f"{t['tail']:.3f} ms, candidates {t['candidates']:.3f} ms; host "
          f"decode of {rows} channels {t['host_decode']:.1f} ms "
          f"({sum(map(len, frames))} frames on noise); peak device memory "
          f"{peak:.0f} MiB")
    return t


def phase_timing(device, card: str) -> dict:
    import torch
    from tetraear_tpu_torch.models.multicarrier import (
        MulticarrierFrontend, PfbMulticarrierFrontend)
    from tetraear_tpu_torch.ops import fused
    from tetraear_tpu_torch.ops.channelizer import carrier_grid
    from tetraear_tpu_torch.ops.kernels import s2d_conv as kc
    x, k2, gc, L, decim = _case(16, BENCH_N, 2, device)
    m_out = -(-BENCH_N // decim)
    flops = 2 * k2.shape[0] * k2.shape[1] * k2.shape[2] * m_out
    t = {}

    def report(name, key, kernel_fn, plain_fn, plain_name, rows=32,
               iters=10):
        ms, plain_ms, runs = _pair_ms(kernel_fn, plain_fn, iters)
        t[key], t[key + "_plain"] = ms, plain_ms
        print(f"[timing] {card}: {name} {runs[0]:.3f} / {runs[1]:.3f} ms "
              f"({flops * rows / 32 / ms / 1e9:.1f} TFLOP/s of the "
              f"un-folded conv), {plain_name} {runs[2]:.3f} / "
              f"{runs[3]:.3f} ms")

    for bf16 in (True, False):
        tag = "bf16" if bf16 else "f32"
        report(f"K1 {tag}", f"k1_{tag}",
               lambda: kc.s2d_conv(x, k2, gc, L, decim, bf16=bf16),
               lambda: kc.s2d_conv_plain(x, k2, gc, L, decim, bf16=bf16),
               "plain F.conv1d")
    report("K3 f32", "k3",
           lambda: kc.s2d_conv_db(x, k2, gc, L, decim),
           lambda: kc.s2d_conv_plain(x, k2, gc, L, decim), "plain F.conv1d")
    report("K3 f32", "k3_vs_k1",
           lambda: kc.s2d_conv_db(x, k2, gc, L, decim),
           lambda: kc.s2d_conv(x, k2, gc, L, decim), "K1 f32")
    k_of = torch.as_tensor(fused.fold_s2d_kernel(k2.cpu().numpy(), 4),
                           device=device)
    for bf16 in (True, False):
        tag = "bf16" if bf16 else "f32"
        report(f"K1-of fold 4 {tag}", f"k1of_{tag}",
               lambda: kc.s2d_conv_of(x, k_of, gc, L, decim, 4, bf16=bf16),
               lambda: kc.s2d_conv_of_plain(x, k_of, gc, L, decim, 4,
                                            bf16=bf16),
               "plain stride-4 F.conv1d + un-fold")
    report("K1-of fold 4 bf16", "k1of_vs_k1",
           lambda: kc.s2d_conv_of(x, k_of, gc, L, decim, 4, bf16=True),
           lambda: kc.s2d_conv(x, k2, gc, L, decim, bf16=True), "K1 bf16")

    mc = MulticarrierFrontend.from_offsets(carrier_grid(16), device=device,
                                           num_candidates=64, threshold=0.80,
                                           conv="pallas_bf16")
    t["fe16"] = _frontend_timing("frontend pallas_bf16, 16 carriers", mc, x,
                                 card, iters=6)
    del mc, x, k_of
    for conv in ("pallas_bf16", "pallas_db"):
        pfb = PfbMulticarrierFrontend.from_config(
            device=device, num_candidates=64, threshold=0.80, conv=conv)
        x = _case(16, BENCH_N, 4, device)[0]
        kp, lp = pfb.kernel_s2d, pfb.L
        if conv == "pallas_bf16":
            report("full band (C2=192, gc=0): K1 bf16", "pfb_k1_bf16",
                   lambda: kc.s2d_conv(x, kp, 0, lp, decim, bf16=True),
                   lambda: kc.s2d_conv_plain(x, kp, 0, lp, decim, bf16=True),
                   "plain F.conv1d", rows=192, iters=6)
        else:
            report("full band (C2=192, gc=0): K3 f32", "pfb_k3",
                   lambda: kc.s2d_conv_db(x, kp, 0, lp, decim),
                   lambda: kc.s2d_conv_plain(x, kp, 0, lp, decim),
                   "plain F.conv1d", rows=192, iters=6)
            report("full band (C2=192, gc=0): K3 f32", "pfb_k3_vs_k1",
                   lambda: kc.s2d_conv_db(x, kp, 0, lp, decim),
                   lambda: kc.s2d_conv(x, kp, 0, lp, decim),
                   "K1 f32", rows=192, iters=6)
        t[f"pfb_{conv}"] = _frontend_timing(
            f"full-band frontend {conv}, 96 channels", pfb, x, card,
            iters=6)
        del pfb, x
        torch.cuda.empty_cache()
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
    errs = phase_kernel(device)
    launches = phase_decode(device)
    t = phase_timing(device, card)
    times = {"s2d_conv": ("k1_bf16", "k1_bf16_plain"),
             "s2d_conv_of": ("k1of_bf16", "k1of_bf16_plain"),
             "s2d_conv_db": ("k3", "k3_plain")}
    print(card)
    print(json.dumps({"kernels": [{
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": launches[name],
        "max_abs_err": errs[name],
        "ms": t[times[name][0]],
        "plain_ms": t[times[name][1]],
    } for name, (source, replaces) in KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
