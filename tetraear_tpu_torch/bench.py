"""Benchmark: IQ samples/s through the multi-carrier demod + decode device
pipeline (the port's copy of bench.py; BASELINE config 4: 16 TETRA
carriers channelized from one wideband stream, demodulated,
sync-correlated and CRC-checked on the device).

    python -m tetraear_tpu_torch.bench [--tier T] [--device cuda|cpu]

Prints ONE JSON line on stdout: {"metric", "value", "unit",
"vs_baseline"}; progress and each tier's rate go to stderr.

Baseline: the reference's pure-Python chain sustains at best ~2.4 MS/s
(BASELINE.md "Realized throughput"), so vs_baseline = samples/s / 2.4e6.

What a tier's rate times: `iters` steps of the tier's frontend on one
block of n = 8000 x 130 x BENCH_SCALE samples (floored to a multiple of
96), each step the conv, the demod tail and the candidates on the
device, ending with the pull of a scalar digest of the last result
(sync scores summed, plus the valid symbol counts) to the host.  The
host MAC/SDS decode is not inside the timed loop.  The rate is
n x iters / (t(iters + 1) - t(1)) on the host's clock, the digest pull
being the sync, under a watchdog; the CUDA-event time of the same steps
is printed beside it.

Tiers (`--tier T`, or `BENCH_TIERS=a,b,...`; without either the default
goals `fused_pallas_bf16` then `pfb` run and the faster one is printed):

    fused_pallas_bf16   build_frontend("pallas_bf16"), K1 bf16
    fused_pallas        "pallas", K1 f32
    fused_pallas_db     "pallas_db", K3
    fused_pallas_of<N>[_bf16]   "pallas_of<N>[_bf16]", K1-of
    pfb                 the 96-channel filterbank on BENCH_PFB_VARIANT
                        (default pallas_bf16, K1 bf16 with 192 rows); the
                        gather form with --device cpu, as the JAX bench
                        runs it on its CPU backend
    complex             the staged DDC bank, K5
    fused, fused_s2d, fused_s2d_of   the plain F.conv1d frontends
    realpair64, realpair0   RealPairFrontend with 64 / 0 candidates
    single              the single-carrier Frontend on 266,240 samples

Knobs: BENCH_CARRIERS (16), BENCH_SCALE (8), BENCH_ITERS (6),
BENCH_PFB_VARIANT (pallas_bf16).

--device defaults to cuda; without a card the bench exits naming
--device cpu.  A card run's metric is
iq_samples_per_sec_per_chip_<C>carrier_<variant>; a --device cpu run's
is iq_samples_per_sec_<C>carrier_<variant>_cpu_fallback, the JAX bench's
CPU label, here marking an explicit --device cpu run (nothing falls
back).  A tier's kernel is built before its first timed step, so a cold
nvcc build is not read as a hang.  Any failure (a kernel that does not
build or launch, an unknown tier, a hung digest) prints the
`bench_failed` line and exits nonzero; no other tier or device stands
in for it.  On SIGTERM, SIGINT or SIGHUP the fastest tier measured so
far is printed.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import threading
import time
import traceback
from typing import Callable, NamedTuple

import numpy as np

BASELINE_SPS = 2.4e6
WATCHDOG_S = 240.0               # steady-state sync watchdog
FIRST_SYNC_S = 210.0             # the warm-up step's watchdog
DEFAULT_TIERS = ("fused_pallas_bf16", "pfb")
PFB_VARIANTS = ("s2d", "pallas", "pallas_db", "pallas_bf16")
NUM_CANDIDATES = 64
THRESHOLD = 0.80

# tier -> variant label; "fused_pallas_of<N>[_bf16]" takes any fold N
TIERS = {
    "fused_pallas_bf16": "fused_pallas_bf16_demod_decode",
    "fused_pallas": "fused_pallas_demod_decode",
    "fused_pallas_db": "fused_pallas_db_demod_decode",
    "fused_pallas_of4": "fused_pallas_of4_demod_decode",
    "fused_pallas_of4_bf16": "fused_pallas_of4_bf16_demod_decode",
    "pfb": "pfb_demod_decode",
    "complex": "demod_decode",
    "fused": "fused_demod_decode",
    "fused_s2d": "fused_s2d_demod_decode",
    "fused_s2d_of": "fused_s2d_of_demod_decode",
    "realpair64": "demod_decode_realpair",
    "realpair0": "demod_sync_realpair",
    "single": "singlecarrier_demod_sync",
}
# launch counter (ops.kernels) -> the csrc source that holds its kernel
KERNEL_SOURCES = {"s2d_conv": "s2d_conv", "s2d_conv_of": "s2d_conv",
                  "s2d_conv_bf16": "s2d_conv_tc",
                  "s2d_conv_of_bf16": "s2d_conv_tc",
                  "s2d_conv_db": "s2d_conv_db",
                  "fused_channelize": "fused_channelize"}


class TierProgram(NamedTuple):
    step: Callable           # input -> the frontend's result
    digest: Callable         # result -> 0-d f32 tensor, queued on the device
    inputs: list             # two input blocks on the device
    n: int                   # samples per step
    variant: str
    carriers: int
    kernel: str | None       # the launch counter of the tier's kernel


class Rate(NamedTuple):
    sps: float               # n x iters / (t(iters + 1) - t(1)), host clock
    n: int
    step_ms: float           # (t(iters + 1) - t(1)) / iters
    event_step_ms: float | None   # CUDA-event time a step of t(iters + 1)

    @property
    def event_sps(self) -> float | None:
        return (None if self.event_step_ms is None
                else self.n / (self.event_step_ms / 1e3))


def _pfb_variant() -> str:
    """BENCH_PFB_VARIANT, validated: an unknown value must fail loudly,
    not select another conv and mislabel the result."""
    v = os.environ.get("BENCH_PFB_VARIANT", "pallas_bf16")
    if v not in PFB_VARIANTS:
        raise SystemExit(f"[bench] BENCH_PFB_VARIANT={v!r} invalid; "
                         f"choose from {PFB_VARIANTS}")
    return v


def block_size(scale: int) -> int:
    """Samples per block: 8000 symbol periods x scale, floored to a
    multiple of 96 (the mixer table's period)."""
    from tetraear_tpu_torch.config import ReceiverConfig
    cfg = ReceiverConfig()
    step = cfg.decimation_factor * cfg.ref_samples_per_symbol
    return (8000 * step * scale // 96) * 96


def block_inputs(num_carriers: int, n: int) -> tuple:
    """(offsets, [x0, x1]): the grid-aligned carrier offsets (multiples
    of 25 kHz, so the real-pair table mixer applies) and two complex64
    noise blocks, drawn as the JAX bench draws them."""
    rng = np.random.default_rng(0)
    offsets = ((np.arange(num_carriers) - num_carriers // 2) * 25e3
               ).astype(np.float32)
    xs = [(rng.standard_normal(n) + 1j * rng.standard_normal(n)
           ).astype(np.complex64) * 0.1 for _ in range(2)]
    return offsets, xs


def _digest(out):
    return out.sync_corr.sum() + out.count.sum().float()


def tier_program(tier: str, num_carriers: int, scale: int,
                 device) -> TierProgram:
    """The tier's frontend on `device`, its digest and its two input
    blocks, untimed; raises ValueError on an unknown tier."""
    import torch

    from tetraear_tpu_torch.config import ReceiverConfig
    from tetraear_tpu_torch.models.multicarrier import (build_frontend,
                                                        conv_variant)
    from tetraear_tpu_torch.models.realpair import RealPairFrontend
    from tetraear_tpu_torch.models.receiver import Frontend

    device = torch.device(device)
    cfg = ReceiverConfig()
    n = block_size(scale)
    offsets, xs_np = block_inputs(num_carriers, n)
    kw = dict(device=device, num_candidates=NUM_CANDIDATES,
              threshold=THRESHOLD)

    def put(blocks):
        return [torch.as_tensor(x, device=device) for x in blocks]

    ddc = {"fused": "fused", "fused_s2d": "s2d", "fused_s2d_of": "s2d_of",
           "complex": "staged"}
    if tier in ddc or tier.startswith("fused_pallas"):
        conv = ddc.get(tier) or tier.removeprefix("fused_")
        mc = build_frontend(conv, offsets_hz=offsets, config=cfg, **kw)
        variant = TIERS.get(tier, f"{tier}_demod_decode")
        return TierProgram(lambda x: mc(x, start_index=0), _digest,
                           put(xs_np), n, variant, num_carriers,
                           conv_variant(conv).kernel)
    if tier == "pfb":
        conv = _pfb_variant()          # checked on every device
        if device.type == "cpu":
            conv = "gather"
        mc = build_frontend(conv, pfb=True, config=cfg, **kw)
        return TierProgram(mc, _digest, put(xs_np), n, TIERS[tier], 96,
                           conv_variant(conv, pfb=True).kernel)
    if tier in ("realpair64", "realpair0"):
        kw["num_candidates"] = 64 if tier == "realpair64" else 0
        rp = RealPairFrontend.from_offsets(offsets, cfg, **kw)
        xs_ri = [np.stack([x.real, x.imag]).astype(np.float32)
                 for x in xs_np]
        return TierProgram(rp, _digest, put(xs_ri), n, TIERS[tier],
                           num_carriers, None)
    if tier == "single":
        fe = Frontend(cfg, device=device)
        n_s = 2048 * cfg.decimation_factor * cfg.ref_samples_per_symbol
        return TierProgram(lambda x: fe(x, 0.0), _digest,
                           put([x[:n_s] for x in xs_np]), n_s, TIERS[tier],
                           1, None)
    raise ValueError(f"unknown tier {tier}")


def _verified_rate(step_fn, digest_fn, inputs, n: int, iters: int) -> Rate:
    """Time `iters` steps ending with a scalar-digest pull to the host
    under a watchdog.  The digest is queued in this thread, on the
    steps' stream; the watchdog thread only waits for its value."""
    import torch
    cuda = getattr(inputs[0], "is_cuda", False)

    def run(iters_inner, watchdog):
        if cuda:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
        t0 = time.perf_counter()
        out = None
        for i in range(iters_inner):
            out = step_fn(inputs[i % len(inputs)])
        if cuda:
            ev[1].record()
        d = digest_fn(out)
        result = {}

        def pull():
            try:
                result["v"] = float(d)
            except Exception as e:  # pragma: no cover
                result["err"] = e

        th = threading.Thread(target=pull, daemon=True)
        th.start()
        th.join(watchdog)
        if "v" in result:
            t = time.perf_counter() - t0
            return t, (ev[0].elapsed_time(ev[1]) / iters_inner
                       if cuda else None)
        if "err" in result:
            raise RuntimeError(f"verified sync failed: {result['err']}")
        raise TimeoutError("verified sync timed out")

    run(1, FIRST_SYNC_S)              # warm-up: first launches, allocations
    t_base, _ = run(1, WATCHDOG_S)    # dispatch + sync floor
    t_full, event_ms = run(iters + 1, WATCHDOG_S)
    dt = max(t_full - t_base, 1e-9)
    return Rate(n * iters / dt, n, dt / iters * 1e3, event_ms)


def _run_tier(tier: str, num_carriers: int, scale: int, iters: int,
              device) -> tuple:
    """One tier on `device` -> (Rate, variant, carriers); on a card its
    kernel is built first (KernelBuildError when nvcc is missing or
    refuses it), so no build runs under the watchdog."""
    prog = tier_program(tier, num_carriers, scale, device)
    if prog.kernel is not None and prog.inputs[0].is_cuda:
        from tetraear_tpu_torch.ops.kernels import build
        build(KERNEL_SOURCES[prog.kernel])
    rate = _verified_rate(prog.step, prog.digest, prog.inputs, prog.n,
                          iters * 4 if tier == "single" else iters)
    return rate, prog.variant, prog.carriers


def _log(msg: str) -> None:
    print(f"[bench {time.strftime('%H:%M:%S', time.gmtime())}] {msg}",
          file=sys.stderr, flush=True)


def _result_line(rec: dict | None) -> str:
    if rec is None:
        return json.dumps({"metric": "bench_failed", "value": 0,
                           "unit": "samples/s", "vs_baseline": 0})
    scope = ("" if rec["variant"].startswith("singlecarrier")
             else f"{rec['carriers']}carrier_")
    if rec.get("backend") == "cpu":
        metric = (f"iq_samples_per_sec_{scope}{rec['variant']}"
                  "_cpu_fallback")
    else:
        metric = f"iq_samples_per_sec_per_chip_{scope}{rec['variant']}"
    return json.dumps({
        "metric": metric,
        "value": round(rec["sps"], 1), "unit": "samples/s",
        "vs_baseline": round(rec["sps"] / BASELINE_SPS, 2)})


class _Reporter:
    """Owns the one-JSON-line stdout contract: the fastest tier offered,
    printed once, also from the SIGTERM net."""

    def __init__(self):
        self.best: dict | None = None
        self._done = False

    def offer(self, rec: dict) -> None:
        if self.best is None or rec["sps"] > self.best["sps"]:
            self.best = rec

    def emit(self) -> int:
        """Print the line (bench_failed without a tier) once; -> exit code."""
        if not self._done:
            self._done = True
            print(_result_line(self.best), flush=True)
        return 0 if self.best else 1

    def fail(self) -> int:
        """Print the bench_failed line, whatever ran before."""
        self.best = None
        return self.emit()

    def install_signal_net(self) -> dict:
        """Emit the best tier so far on SIGTERM, SIGINT or SIGHUP; ->
        the handlers it replaced."""
        def handler(signum, frame):          # pragma: no cover
            _log(f"signal {signum}: emitting the best tier so far")
            os._exit(self.emit())
        previous = {}
        for sig in (signal.SIGTERM, signal.SIGINT, signal.SIGHUP):
            try:
                previous[sig] = signal.signal(sig, handler)
            except (ValueError, OSError):
                pass
        return previous


def _device(name: str):
    import torch
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {name}: no CUDA device is available; "
                         "pass --device cpu to run on the CPU")
    return dev


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m tetraear_tpu_torch.bench")
    ap.add_argument("--tier", default=None,
                    help="run this tier only (else BENCH_TIERS, else "
                         + " then ".join(DEFAULT_TIERS) + ")")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; without a card the "
                         "bench refuses to run unless given --device cpu)")
    args = ap.parse_args(argv)
    rep = _Reporter()
    try:
        device = _device(args.device)
    except SystemExit:
        rep.fail()
        raise
    kw = dict(num_carriers=int(os.environ.get("BENCH_CARRIERS", 16)),
              scale=int(os.environ.get("BENCH_SCALE", 8)),
              iters=int(os.environ.get("BENCH_ITERS", 6)), device=device)
    tiers_env = os.environ.get("BENCH_TIERS")
    tiers = ([args.tier] if args.tier else
             [t.strip() for t in tiers_env.split(",") if t.strip()]
             if tiers_env else list(DEFAULT_TIERS))
    previous = rep.install_signal_net()
    try:
        for tier in tiers:
            _log(f"tier {tier} on {device}")
            try:
                rate, variant, carriers = _run_tier(tier, **kw)
            except SystemExit:
                rep.fail()
                raise
            except Exception as e:
                traceback.print_exc()
                _log(f"tier {tier} failed ({type(e).__name__}: {e}); no "
                     "other tier stands in for it")
                return rep.fail()
            event = ("" if rate.event_step_ms is None else
                     f"; CUDA events {rate.event_step_ms:.3f} ms a step = "
                     f"{rate.event_sps:,.0f} samples/s")
            _log(f"tier {tier}: {rate.sps:,.0f} samples/s "
                 f"({rate.step_ms:.3f} ms a step, host clock){event}")
            rep.offer({"tier": tier, "sps": rate.sps, "variant": variant,
                       "carriers": carriers, "backend": device.type})
        return rep.emit()
    finally:
        for sig, handler in previous.items():
            signal.signal(sig, handler)


if __name__ == "__main__":
    sys.exit(main())
