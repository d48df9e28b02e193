"""Drive the PyTorch/CUDA port once on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases (each prints its results; the first failure exits nonzero):
  1. device   refuse to run without CUDA; print the card's name and
              power limit as nvidia-smi reports them
  2. build    compile K1 / K1-of (tetraear_tpu_torch/csrc/s2d_conv.cu),
              K3 (csrc/s2d_conv_db.cu), K4 (csrc/s2d_conv_dt.cu) and K5
              (csrc/fused_channelize.cu) with nvcc for sm_90a, one nvcc per
              source, all at once; print the build times and ptxas's
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
              at the ragged n; K4 (dt, dt_bf16) at the bench shape and on
              the filterbank kernel at the ragged n; K5 against
              mix_to_baseband + fir_decimate at carrier_grid(16), the
              frontend's 121 taps, the bench n and start 0, and at the
              ragged n and start 10^7, both also against a float64
              oracle of the same f32 phases on a sample of outputs
  4. decode   the main paths through the entry points a user calls, each
              on a planted signal, every launch count set to 0 just before
              and read just after: `tetraear_tpu_torch.ui.cli.main(
              ["decode", f, "--carriers", "16", "--conv", "pallas_bf16"])`
              and the same with "--pfb" (all 96 channels; texts on their
              fftfreq channels), both launching K1;
              `PfbMulticarrierFrontend(conv="pallas_db")` (K3),
              `MulticarrierFrontend(conv="pallas_of4_bf16")` (K1-of), the
              staged `StagedMulticarrierFrontend` (K5),
              `RealPairFrontend(num_candidates=64)` on the bench's
              grid-aligned offsets, the gather-form `GatherPfbFrontend`
              and the op-level `pallas_s2d_conv(variant="dt")` (K4) with
              the real-pair tail, all through `MulticarrierDecoder`.
              Every planted SDS text must come back on its channel, and
              each path's kernel must have launched
  5. single   the single-carrier receiver and the etsi link on the card,
              plain PyTorch (no kernel of the table; the launch counts
              are set to 0 before each path and read after it): the
              golden captures clean, noisy_offset, encrypted and the
              chunked long_mixed through the ref-exact `SignalProcessor`
              and `TetraDecoder`, every golden key equal; the CLI's
              `decode --profile ref-compat | ref-exact | etsi` on planted
              captures, each text found; `transmit` -> `EtsiLinkReceiver`
              clean (4 of 4 CRC-ok) and at 12 dB (at least 3 of 4), the
              MAC bits the ones sent
  6. timing   at n = 8,319,936, K = 64, threshold 0.80, with CUDA events:
              K1, K3, K1-of (fold 4) and K4 against their plain versions
              and K1, at C2 = 32 and (K1, K3) on the filterbank kernel;
              the 16-carrier (pallas_bf16) and full-band (pallas_bf16,
              pallas_db) frontends' stages, end-to-end rate, device busy
              share (torch.profiler), peak memory and host decode; K5
              against the plain mixer + FIR with the peak memory of
              both, and with every phase on sincosf's fast path; the
              staged frontend's stages; RealPairFrontend(64)
              and the gather-form full band end to end; then each
              single-carrier profile's block demodulator on one
              262,144-sample chunk, its busy share, the IIR's two
              filtfilts alone, the host decoder on one chunk and the
              SCH/F Viterbi decode of 1 and 16 blocks

The line before the last is a JSON object with each kernel's route,
source, launches in phases 4 and 5, error and times; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import functools
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

BENCH_N = 8_319_936          # bench.py's n per block
RAGGED_N = 1_000_007
TOL = 4e-6                   # x max|plain|: f32 sum order only (K5:
                             # the 121-tap FIR's, plus the <= 2 ulp spread
                             # of sincosf against torch.sin / torch.cos)
BF16_TOL = 1e-2              # x max|f32 plain|: bf16 operand rounding
PLANTED = (3, 8, 12)         # grid indices of carrier_grid(16)
K5_START = 10_000_000        # a start index where |phase| reaches ~5e6 rad
KERNELS = {                  # wrapper -> (source, TPU kernel it replaces)
    "s2d_conv": ("tetraear_tpu_torch/csrc/s2d_conv.cu",
                 "tetraear_tpu/ops/pallas/s2d_conv.py:71"),
    "s2d_conv_of": ("tetraear_tpu_torch/csrc/s2d_conv.cu",
                    "tetraear_tpu/ops/pallas/s2d_conv.py:371"),
    "s2d_conv_db": ("tetraear_tpu_torch/csrc/s2d_conv_db.cu",
                    "tetraear_tpu/ops/pallas/s2d_conv.py:162"),
    "s2d_conv_dt": ("tetraear_tpu_torch/csrc/s2d_conv_dt.cu",
                    "tetraear_tpu/ops/pallas/s2d_conv.py:108"),
    "fused_channelize": ("tetraear_tpu_torch/csrc/fused_channelize.cu",
                         "tetraear_tpu/ops/pallas/fused_channelize.py:59"),
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
    from tetraear_tpu_torch.ops.kernels import (SOURCES, KernelBuildError,
                                                build)
    sources = SOURCES
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


@functools.lru_cache(maxsize=None)
def _s2d_kernel(num_carriers, device) -> tuple:
    """(s2d kernel, gc, L, D) of the frontend for carrier_grid(num_carriers)
    or, for "pfb", the full-band filterbank's; designed once per run."""
    from tetraear_tpu_torch.models.multicarrier import (
        MulticarrierFrontend, PfbMulticarrierFrontend)
    from tetraear_tpu_torch.ops.channelizer import carrier_grid
    if num_carriers == "pfb":
        mc = PfbMulticarrierFrontend.from_config(device=device, conv="s2d")
    else:
        mc = MulticarrierFrontend.from_offsets(carrier_grid(num_carriers),
                                               device=device, conv="s2d")
    return mc.kernel_s2d, mc.gc, mc.L, mc.decim


def _case(num_carriers, n: int, seed: int, device):
    """(x, s2d kernel, gc, L, D) on the card: complex noise * 0.1 and the
    frontend's composite kernel for carrier_grid(num_carriers), or the
    full-band filterbank's for "pfb"."""
    import torch
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(n, dtype=torch.complex64, device=device,
                    generator=gen) * 0.1
    return (x,) + _s2d_kernel(num_carriers, device)


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
    from tetraear_tpu_torch.ops.kernels import launches
    before = launches()[wrapper]
    out = fn()
    torch.cuda.synchronize()
    if launches()[wrapper] != before + 1:
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
    worst["s2d_conv_dt"] = kernel_k4(device)
    worst["fused_channelize"] = kernel_k5(device)
    return worst


def kernel_k4(device) -> float:
    """K4 (dt, dt_bf16) against the plain conv with K1's bounds: the f32
    sum-order bound (bf16 operands rounded alike on both sides) and, for
    bf16, BF16_TOL of the f32 result.  The filterbank kernel's 192 rows
    and pad_l = 767 at the ragged n."""
    from tetraear_tpu_torch.ops.kernels import s2d_conv as kc
    worst = 0.0
    for num_carriers, n in ((16, BENCH_N), ("pfb", RAGGED_N)):
        x, k2, gc, L, decim = _case(num_carriers, n, 5, device)
        f32 = kc.s2d_conv_plain(x, k2, gc, L, decim)
        for bf16 in (False, True):
            got = _launched("s2d_conv_dt", lambda: kc.s2d_conv_dt(
                x, k2, gc, L, decim, bf16=bf16))
            want = (kc.s2d_conv_plain(x, k2, gc, L, decim, bf16=True)
                    if bf16 else f32)
            tag = (f"K4 {num_carriers} C2={k2.shape[0]} gc={gc} n={n} "
                   f"{'dt_bf16' if bf16 else 'dt'}")
            worst = max(worst, _held(tag, "K4", got, want, TOL))
            if bf16:
                _held(tag + " vs f32", "K4", got, f32, BF16_TOL)
        del x, got, want, f32
    return worst


def _k5_oracle(x, offsets, taps, fs: float, decim: int, start: int,
               m_idx):
    """channelize in float64 on the host at outputs m_idx, from the same
    f32 phases (channelizer.mixer_phase, the plain version's and K5's):
    (C, len(m_idx)) complex128."""
    import numpy as np
    from tetraear_tpu_torch.ops.channelizer import mixer_phase
    n = x.shape[0]
    L = len(taps)
    q = (m_idx[:, None] * decim + (L - 1) // 2 - np.arange(L)[None, :])
    ok = (q >= 0) & (q < n)
    qc = np.clip(q, 0, n - 1)
    ph = mixer_phase(offsets, n, fs, start)[:, qc.ravel()]
    ph = ph.cpu().numpy().astype(np.float64).reshape(len(offsets), *q.shape)
    xs = x.cpu().numpy()[qc].astype(np.complex128) * ok
    taps64 = taps.cpu().numpy().astype(np.float64)
    return np.einsum("k,cmk->cm", taps64, xs[None] * np.exp(1j * ph))


def kernel_k5(device) -> float:
    """K5 against mix_to_baseband + fir_decimate on the card, both with
    the same f32 phases: the FIR's f32 sum order plus the <= 2 ulp spread
    of sincosf against torch.sin / torch.cos, within TOL x max|plain|.
    Both are also held against a float64 oracle of the same phases on
    256 outputs, which says which of the two is off if they disagree."""
    import numpy as np
    import torch
    from tetraear_tpu_torch.models.realpair import staged_state
    from tetraear_tpu_torch.ops.channelizer import carrier_grid
    from tetraear_tpu_torch.ops.kernels import fused_channelize as k5
    state = staged_state(carrier_grid(16))
    offs = torch.as_tensor(state.offsets_hz, device=device)
    taps = torch.as_tensor(state.taps_d, device=device)
    fs = state.sample_rate_hz
    worst = 0.0
    for n, start in ((BENCH_N, 0), (RAGGED_N, K5_START)):
        gen = torch.Generator(device=device).manual_seed(6)
        x = torch.randn(n, dtype=torch.complex64, device=device,
                        generator=gen) * 0.1
        got = _launched("fused_channelize", lambda: k5.fused_channelize(
            x, offs, fs, state.decim, taps, start))
        want = k5.fused_channelize_plain(x, offs, fs, state.decim, taps,
                                         start)
        m_idx = np.random.default_rng(start).choice(got.shape[1], 256,
                                                    replace=False)
        oracle = _k5_oracle(x, offs, taps, fs, state.decim, start, m_idx)
        errs = {name: np.abs(y[:, m_idx].cpu().numpy() - oracle).max()
                for name, y in (("K5", got), ("plain", want))}
        tag = f"K5 16 carriers L={len(taps)} n={n} start={start}"
        print(f"[kernel] {tag}: max|phase| = "
              f"{2 * np.pi * offs.abs().max().item() * (start + n) / fs:.3e}"
              " rad; on 256 "
              f"outputs max|K5-f64 oracle| = {errs['K5']:.3e}, "
              f"max|plain-f64 oracle| = {errs['plain']:.3e}")
        bound = TOL * want.abs().max().item()
        if (got - want).abs().max().item() > bound:
            off = max(errs, key=errs.get)
            print(f"[kernel] {tag}: K5 and plain disagree; {off} is the "
                  "farther from the float64 oracle")
        worst = max(worst, _held(tag, "K5", got, want, TOL))
        del x, got, want
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


def _path(tag: str, wrapper, run) -> dict:
    """Runs one main path with every kernel module's launch counts set to
    0 just before and read just after; the path's kernel (None for a path
    of plain PyTorch) must have launched."""
    from tetraear_tpu_torch.ops.kernels import launches, reset_launches
    reset_launches()
    run()
    counts = launches()
    print(f"[decode] {tag}: launches {counts}")
    if wrapper is not None and counts[wrapper] == 0:
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
    import torch
    from tetraear_tpu_torch.models.multicarrier import (
        GatherPfbFrontend, MulticarrierDecoder, MulticarrierFrontend,
        PfbMulticarrierFrontend, StagedMulticarrierFrontend)
    from tetraear_tpu_torch.models.realpair import (RealPairFrontend,
                                                    _demod_from_pair)
    from tetraear_tpu_torch.ops.channelizer import carrier_grid
    from tetraear_tpu_torch.ops.kernels.s2d_conv import pallas_s2d_conv
    from tetraear_tpu_torch.utils.synth import (planted_grid, planted_pfb,
                                                planted_wideband)
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
    staged = StagedMulticarrierFrontend.from_offsets(carrier_grid(16),
                                                     device=device)
    add(_path("StagedMulticarrierFrontend (fused=False)", "fused_channelize",
              lambda: module_run("16 carriers staged", staged, x16, 16,
                                 want16)))
    xg, offs_g, want_g = planted_grid(PLANTED)
    rp = RealPairFrontend.from_offsets(offs_g, device=device,
                                       num_candidates=64)
    add(_path("RealPairFrontend(64)", None, lambda: module_run(
        "real-pair 16 carriers", rp, xg, 16, want_g)))
    gather = GatherPfbFrontend(device=device)
    add(_path("GatherPfbFrontend (PFB fused=False)", None, lambda: module_run(
        "pfb gather", gather, xpfb, 96, wantpfb)))

    def dt_run():
        # the op-level entry point of K4, then the real-pair tail
        x = torch.as_tensor(x16, device=device)
        out = pallas_s2d_conv(x, mc.kernel_s2d, mc.gc, mc.L, mc.decim,
                              variant="dt")
        res = _demod_from_pair(out[:16], out[16:], mc.sps,
                               z_rot=(mc.z_cos, mc.z_sin))
        frames = MulticarrierDecoder(16).decode(
            mc.candidates(res.bits, res.sync_corr, res.count))
        _check_texts("16 carriers pallas_s2d_conv dt", want16,
                     _texts(frames))
    add(_path("pallas_s2d_conv(variant='dt') + real-pair tail",
              "s2d_conv_dt", dt_run))
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
    phase_timing_k4(device, card, t)
    phase_timing_staged(device, card, t)
    return t


def phase_timing_k4(device, card: str, t: dict) -> None:
    """K4 against its plain version and against K1 at C2 = 32."""
    from tetraear_tpu_torch.ops.kernels import s2d_conv as kc
    x, k2, gc, L, decim = _case(16, BENCH_N, 2, device)
    for bf16 in (False, True):
        tag = "bf16" if bf16 else "f32"
        for key, other, name in (
                ("plain", lambda: kc.s2d_conv_plain(x, k2, gc, L, decim,
                                                    bf16=bf16),
                 "plain F.conv1d"),
                ("k1", lambda: kc.s2d_conv(x, k2, gc, L, decim, bf16=bf16),
                 f"K1 {tag}")):
            ms, other_ms, runs = _pair_ms(
                lambda: kc.s2d_conv_dt(x, k2, gc, L, decim, bf16=bf16),
                other, 10)
            t.setdefault(f"k4_{tag}", ms)
            t[f"k4_{tag}_{key}"] = other_ms
            print(f"[timing] {card}: K4 {'dt_bf16' if bf16 else 'dt'} "
                  f"{runs[0]:.3f} / {runs[1]:.3f} ms, {name} {runs[2]:.3f} / "
                  f"{runs[3]:.3f} ms")


def _peak_mib(fn) -> float:
    """Peak device memory fn() allocates above what is allocated before."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 2**20


def _e2e(tag: str, fn, n: int, card: str, iters: int) -> float:
    """End-to-end ms per block, rate, peak memory and busy share."""
    ms = _time_ms(fn, iters, warmup=1)
    peak = _peak_mib(fn)
    busy_ms, top = _device_busy_ms(fn, iters=2)
    busy = ("not measured" if busy_ms is None else
            f"{busy_ms:.3f} ms ({busy_ms / ms:.1%}); top kernel "
            f"{top[0][1]:.3f} ms {top[0][0][:60]}")
    print(f"[timing] {card}: {tag} (n={n}, K=64) {ms:.3f} ms/block = "
          f"{n / (ms / 1e3):,.0f} samples/s; peak device memory above the "
          f"input {peak:.0f} MiB; device busy {busy}")
    return ms


def phase_timing_staged(device, card: str, t: dict) -> None:
    """K5 against the plain mixer + FIR with the peak memory of both, the
    staged frontend's stages, and the real-pair and gather-form
    frontends end to end, at the bench n."""
    import torch
    from tetraear_tpu_torch.models.multicarrier import (
        GatherPfbFrontend, StagedMulticarrierFrontend, _demod_front)
    from tetraear_tpu_torch.models.realpair import RealPairFrontend
    from tetraear_tpu_torch.ops.channelizer import carrier_grid
    from tetraear_tpu_torch.ops.fir import fir_filter_same
    from tetraear_tpu_torch.ops.kernels import fused_channelize as k5
    x = _case(16, BENCH_N, 7, device)[0]
    mc = StagedMulticarrierFrontend.from_offsets(carrier_grid(16),
                                                 device=device)
    args = (mc.offsets_hz, mc.sample_rate_hz, mc.decim, mc.taps_d)
    ms, plain_ms, runs = _pair_ms(lambda: k5.fused_channelize(x, *args),
                                  lambda: k5.fused_channelize_plain(x, *args))
    t["k5"], t["k5_plain"] = ms, plain_ms
    peak = _peak_mib(lambda: k5.fused_channelize(x, *args))
    plain_peak = _peak_mib(lambda: k5.fused_channelize_plain(x, *args))
    print(f"[timing] {card}: K5 16 carriers L={len(mc.taps_d)} "
          f"{runs[0]:.3f} / {runs[1]:.3f} ms, plain mix_to_baseband + "
          f"fir_decimate {runs[2]:.3f} / {runs[3]:.3f} ms; peak device "
          f"memory above the input {peak:.0f} MiB vs {plain_peak:.0f} MiB")
    busy_ms, top = _device_busy_ms(lambda: k5.fused_channelize(x, *args))
    if busy_ms is not None:
        print(f"[timing]   K5 device time {busy_ms:.3f} ms: "
              + ", ".join(f"{name[:40]} {v:.3f}" for name, v in top[:3]))
    # the same launch with every |phase| under 105615 rad, where sincosf
    # never takes its slow reduction (16 carriers at 1 kHz: |phase| <=
    # 2.2e4 rad over the block): the difference is the slow path's cost
    low = torch.full_like(mc.offsets_hz, 1e3)
    fast_ms = _time_ms(lambda: k5.fused_channelize(x, low, *args[1:]))
    print(f"[timing] {card}: K5 with every phase on sincosf's fast path "
          f"{fast_ms:.3f} ms (the bench carriers' {ms:.3f} ms)")
    t["k5_fast_path"] = fast_ms
    y = k5.fused_channelize(x, *args)
    yc = fir_filter_same(y, mc.taps_c)
    bits, corr, count = _demod_front(yc, mc.sps)
    stages = {"channel FIR": lambda: fir_filter_same(y, mc.taps_c),
              "demod front": lambda: _demod_front(yc, mc.sps),
              "candidates": lambda: mc.candidates(bits, corr, count)}
    print(f"[timing] {card}: staged frontend stages: " + ", ".join(
        f"{name} {_time_ms(fn, 6):.3f} ms" for name, fn in stages.items()))
    del y, yc, bits, corr, count
    t["staged"] = _e2e("staged frontend (K5), 16 carriers", lambda: mc(x),
                       BENCH_N, card, 6)
    del mc
    offs = ((torch.arange(16) - 8) * 25e3).numpy()
    rp = RealPairFrontend.from_offsets(offs, device=device,
                                       num_candidates=64)
    t["realpair64"] = _e2e("RealPairFrontend(64), 16 carriers",
                           lambda: rp(x), BENCH_N, card, 6)
    del rp
    gather = GatherPfbFrontend(device=device)
    t["gather"] = _e2e("gather-form full band, 96 channels",
                       lambda: gather(x), BENCH_N, card, 3)
    del gather, x
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# The single-carrier receiver and the etsi link (plain PyTorch on the card)
# ---------------------------------------------------------------------------

FIXTURES = (Path(__file__).resolve().parent / "tests" / "conformance"
            / "fixtures")
SC_CHUNK = 262_144           # the CLI's default --chunk-size


def _load_capture(name: str):
    """A golden capture as complex64 (.cf32: float32 I/Q; .sc16: int16
    I/Q in SC16-Q11, scaled by 1/2048) and its golden frames."""
    import numpy as np
    path = FIXTURES / (f"{name}.sc16" if name == "long_mixed"
                       else f"{name}.cf32")
    raw = np.fromfile(path, np.int16 if path.suffix == ".sc16"
                      else np.float32).astype(np.float32).reshape(-1, 2)
    scale = 1 / 2048 if path.suffix == ".sc16" else 1.0
    iq = ((raw[:, 0] + 1j * raw[:, 1]) * scale).astype(np.complex64)
    lines = (FIXTURES / f"{name}.golden.jsonl").read_text().splitlines()
    return iq, json.loads(lines[0])["__meta__"], list(map(json.loads,
                                                          lines[1:]))


def _sanitize(obj):
    """A frame dict as plain JSON values (tools/make_golden.py's rules)."""
    import dataclasses
    import numpy as np
    if isinstance(obj, dict):
        return {k: _sanitize(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_sanitize(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, (np.integer, np.floating, np.bool_)):
        return obj.item()
    if isinstance(obj, (bytes, bytearray)):
        return obj.hex()
    if dataclasses.is_dataclass(obj):
        return _sanitize(dataclasses.asdict(obj))
    return obj


def _check_golden(name: str, frames: list, golden: list) -> None:
    """Every golden key of every frame equal, or the run fails."""
    if len(frames) != len(golden):
        fail("single", f"{name}: {len(frames)} frames vs {len(golden)} golden")
    for i, (mine, gold) in enumerate(zip(frames, golden)):
        mine = json.loads(json.dumps(_sanitize(mine), sort_keys=True))
        bad = [k for k, v in gold.items() if mine.get(k, ...) != v]
        if bad:
            fail("single", f"{name}[{i}]: keys {bad} differ from the golden")
    print(f"[single] golden {name}: {len(frames)} frames, every golden key "
          "equal")


def _golden_run(device) -> None:
    """The three captures, then long_mixed through the chunked loop (one
    stateful decoder, a fresh receiver per chunk), ref-exact on the card."""
    from tetraear_tpu_torch.core.decoder import TetraDecoder
    from tetraear_tpu_torch.models.receiver import (ReceiverConfig,
                                                    SignalProcessor)
    cfg = ReceiverConfig(profile="ref-exact")
    for name in ("clean", "noisy_offset", "encrypted"):
        iq, meta, golden = _load_capture(name)
        sp = SignalProcessor(config=cfg, device=device)
        symbols = sp.process(iq, freq_offset=meta["freq_offset_hz"])
        frames = TetraDecoder(auto_decrypt=meta["auto_decrypt"],
                              device=device).decode(symbols)
        _check_golden(name, frames, golden)
    iq, meta, golden = _load_capture("long_mixed")
    dec = TetraDecoder(auto_decrypt=meta["auto_decrypt"], device=device)
    frames, n_chunks = [], 0
    t0 = time.perf_counter()
    for start in range(0, len(iq), meta["chunk_samples"]):
        chunk = iq[start:start + meta["chunk_samples"]]
        if len(chunk) < 1000:
            break
        sp = SignalProcessor(config=cfg, device=device)
        for fr in dec.decode(sp.process(chunk, freq_offset=0.0)):
            fr["chunk"] = n_chunks
            frames.append(fr)
        n_chunks += 1
    dt = time.perf_counter() - t0
    if n_chunks != meta["chunks"]:
        fail("single", f"long_mixed: {n_chunks} chunks vs {meta['chunks']}")
    _check_golden("long_mixed", frames, golden)
    print(f"[single] long_mixed ({len(iq)} samples, {n_chunks} chunks) "
          f"through the ref-exact loop in {dt:.3f} s (host clock) = "
          f"{len(iq) / dt:,.0f} samples/s")


def _single_cli_run(profile: str) -> None:
    """The port's CLI `decode --profile P` on a planted capture (etsi: a
    true-rate pi/4 capture); the planted text must come back."""
    import numpy as np
    from tetraear_tpu_torch.ui.cli import main
    from tetraear_tpu_torch.utils.synth import planted_single
    x, text = planted_single(profile)
    with tempfile.TemporaryDirectory() as tmp:
        iq = Path(tmp) / "planted.cf32"
        out = Path(tmp) / "planted_frames.jsonl"
        np.asarray(x, np.complex64).view(np.float32).tofile(iq)
        rc = main(["decode", str(iq), "--profile", profile, "-o", str(out)])
        texts = [json.loads(line).get("sds_message")
                 for line in out.read_text().splitlines()]
    hit = text in texts
    print(f"[single] cli --profile {profile}: exit {rc}, {len(texts)} frames, "
          f"{text!r} {'found' if hit else 'MISSING'}")
    if rc != 0 or not hit:
        fail("single", f"cli --profile {profile} did not decode {text!r}")


def _mac_block(payload: bytes, seed: int):
    """A 268-bit SCH/F MAC-RESOURCE block: header, payload, random fill."""
    import numpy as np
    def u(v, n):
        return [(v >> (n - 1 - i)) & 1 for i in range(n)]
    bits = [0] * 5 + u(0x0ABC, 24) + u(len(payload), 6)
    bits += list(np.unpackbits(np.frombuffer(payload, np.uint8)))
    bits += list(np.random.default_rng(seed).integers(0, 2, 268 - len(bits)))
    return np.array(bits, np.uint8)


def _etsi_link_run(device) -> None:
    """transmit -> EtsiLinkReceiver on the card: clean, every frame
    CRC-ok; at 12 dB, at least 3 of 4; every CRC-ok frame's MAC bits the
    ones sent."""
    import numpy as np
    from tetraear_tpu_torch.models.etsi_link import (EtsiLinkReceiver,
                                                     transmit)
    for snr_db, seed, need in ((None, 5, 4), (12, 7, 3)):
        macs = [_mac_block(b"LINK %d" % i, seed + i) for i in range(4)]
        iq = transmit(macs, snr_db=snr_db, seed=seed)
        frames = EtsiLinkReceiver(device=device).receive(iq)
        good = [f for f in frames if f.crc_ok]
        same = all(any(np.array_equal(f.mac_bits, m) for m in macs)
                   for f in good)
        cond = "clean" if snr_db is None else f"{snr_db} dB"
        print(f"[single] etsi link SCH/F, {cond}: {len(frames)} bursts "
              f"found, {len(good)} of {len(macs)} CRC-ok, MAC bits "
              f"{'equal' if same else 'DIFFER'}")
        if len(good) < need or not same:
            fail("single", "etsi link round trip failed")


def phase_single(device) -> dict:
    """The single-carrier paths through their entry points, each with the
    launch counts set to 0 just before and read just after (they are
    plain PyTorch: no kernel of the table runs)."""
    launches = dict.fromkeys(KERNELS, 0)
    runs = [("golden captures, ref-exact SignalProcessor + TetraDecoder",
             lambda: _golden_run(device))]
    runs += [(f"cli decode --profile {p}", lambda p=p: _single_cli_run(p))
             for p in ("ref-compat", "ref-exact", "etsi")]
    runs.append(("etsi link round trip", lambda: _etsi_link_run(device)))
    for tag, run in runs:
        for name, n in _path(tag, None, run).items():
            launches[name] += n
    return launches


def phase_timing_single(device, card: str) -> None:
    """Each profile's block demodulator on one CLI chunk (CUDA events, input
    already on the card), its device busy share, the IIR's parts, the
    host decoder and the Viterbi channel decode."""
    import numpy as np
    import torch
    from tetraear_tpu_torch.core.decoder import TetraDecoder
    from tetraear_tpu_torch.models.receiver import (Frontend, ReceiverConfig,
                                                    channel_cutoff)
    from tetraear_tpu_torch.models.receiver_etsi import EtsiReceiver
    from tetraear_tpu_torch.ops import channel_coding as cc
    from tetraear_tpu_torch.ops import iir
    iq = _load_capture("long_mixed")[0]
    x = torch.as_tensor(iq[SC_CHUNK:2 * SC_CHUNK], device=device)
    for profile in ("ref-compat", "ref-exact", "etsi"):
        cfg = ReceiverConfig(profile=profile)
        fe = (EtsiReceiver if profile == "etsi" else Frontend)(
            cfg, device=device)
        ms = _time_ms(lambda: fe(x, 0.0), 20, warmup=3)
        busy_ms, top = _device_busy_ms(lambda: fe(x, 0.0))
        busy = ("not measured" if busy_ms is None else
                f"{busy_ms:.3f} ms ({busy_ms / ms:.1%}); top kernels "
                + ", ".join(f"{k[:40]} {v:.3f}" for k, v in top[:3]))
        print(f"[timing] {card}: single carrier {profile} Frontend "
              f"(n={SC_CHUNK}) {ms:.3f} ms/chunk = "
              f"{SC_CHUNK / (ms / 1e3):,.0f} samples/s; device busy {busy}")
        if profile == "ref-exact":
            res = fe(x, 0.0)
            symbols = res.hard_symbols[:int(res.count) - 1].cpu().numpy()
    cut = channel_cutoff(ReceiverConfig(profile="ref-exact"))
    y = iir.decimate_exact(x, 10)
    parts = {"decimate_exact (cheby1-8 filtfilt at 2.4 MS/s)":
             lambda: iir.decimate_exact(x, 10),
             "butter_filtfilt_exact (butter-4 filtfilt at 240 kHz)":
             lambda: iir.butter_filtfilt_exact(y, cut)}
    for name, fn in parts.items():
        ms = _time_ms(fn, 20, warmup=3)
        busy_ms, _ = _device_busy_ms(fn)
        print(f"[timing] {card}: IIR {name}: {ms:.3f} ms, device busy "
              + ("not measured" if busy_ms is None else f"{busy_ms:.3f} ms"))
    dec = TetraDecoder(auto_decrypt=True, device=device)
    dec.decode(symbols)
    t0 = time.perf_counter()
    frames = dec.decode(symbols)
    host = (time.perf_counter() - t0) * 1e3
    print(f"[timing] {card}: host TetraDecoder.decode of one ref-exact "
          f"chunk ({len(symbols)} dibits, {len(frames)} frames): "
          f"{host:.1f} ms (host clock)")
    for batch in (1, 16):
        llrs = torch.as_tensor(np.random.default_rng(0).standard_normal(
            (batch, 432)).astype(np.float32), device=device)
        ms = _time_ms(lambda: cc.decode_channel_soft(llrs), 5, warmup=1)
        print(f"[timing] {card}: SCH/F channel decode (Viterbi over 288 "
              f"trellis steps) of {batch} block(s): {ms:.3f} ms")


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
    t0 = time.perf_counter()
    phase_build()
    t1 = time.perf_counter()
    errs = phase_kernel(device)
    t2 = time.perf_counter()
    launches = phase_decode(device)
    t3 = time.perf_counter()
    for name, n in phase_single(device).items():
        launches[name] += n
    t4 = time.perf_counter()
    t = phase_timing(device, card)
    t5 = time.perf_counter()
    phase_timing_single(device, card)
    print(f"[timing] phases: build {t1 - t0:.1f} s, kernel {t2 - t1:.1f} s, "
          f"decode {t3 - t2:.1f} s, single {t4 - t3:.1f} s, timing "
          f"{t5 - t4:.1f} s, single timing {time.perf_counter() - t5:.1f} s")
    times = {"s2d_conv": ("k1_bf16", "k1_bf16_plain"),
             "s2d_conv_of": ("k1of_bf16", "k1of_bf16_plain"),
             "s2d_conv_db": ("k3", "k3_plain"),
             "s2d_conv_dt": ("k4_f32", "k4_f32_plain"),
             "fused_channelize": ("k5", "k5_plain")}
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
