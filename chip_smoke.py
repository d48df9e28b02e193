"""Drive the PyTorch/CUDA port once on one NVIDIA card and check it.

    python3 chip_smoke.py

Before anything else it installs an import guard that refuses `jax` and
the JAX package `tetraear_tpu` (not `tetraear_tpu_torch`): the run itself
shows that the port needs neither.

Phases (each prints its results; the first failure exits nonzero):
  1. device   refuse to run without CUDA; print the card's name and
              power limit as nvidia-smi reports them
  2. build    compile K1 / K1-of f32 (tetraear_tpu_torch/csrc/s2d_conv.cu),
              K1 / K1-of bf16 on the tensor cores (csrc/s2d_conv_tc.cu),
              K3 (csrc/s2d_conv_db.cu), K4 (csrc/s2d_conv_dt.cu), K5
              (csrc/fused_channelize.cu), the Viterbi (csrc/viterbi.cu)
              and the sync walk (csrc/sync_walk.cu) with nvcc for
              sm_90a, one nvcc per source, all at once; print the build
              times and ptxas's report
  3. kernel   each kernel against its plain PyTorch version on the card:
              K1, f32 and bf16, at C2 = 32 with the bench's n = 8,319,936,
              at C2 = 192 with a ragged n = 1,000,007, and on the full-band
              filterbank kernel (C2 = 192, gc = 0) at n = 8,319,936, bf16
              also at the ragged n on an input one sample into its
              storage; K3 at the 16-carrier bench shape, on the filterbank
              kernel at the bench n and the ragged n, and on inputs that
              start one sample into their storage (off the 16-byte grid of
              its async copies), each bit-equal to K1 f32; K1-of at fold 4
              (f32 and bf16) at the bench shape and folds 6 and 1 at the
              ragged n; K4 (dt on the CUDA cores, dt_bf16 on the tensor
              cores within tc_tol) at the bench shape and on the
              filterbank kernel at the ragged n; K5 against
              mix_to_baseband + fir_decimate at carrier_grid(16), the
              frontend's 121 taps (its specialised path), the bench n and
              start 0, and at the ragged n and starts 10^7 and past 2^24,
              then the generic path on the staged frontend's taps at
              8 MS/s, each also against a float64 oracle of the same f32
              phases on a sample of outputs; and K5 at the carrier counts
              `scan --wideband` gives it (C = 1, the 3 planted channels of
              phase 4c and all 95 channels of a sweep) on the sweep's
              offsets at its n = 1,044,480
  3b. viterbi the Viterbi kernel (csrc/viterbi.cu) against its plain
              version at the downlink cell's four calls a multiframe (N =
              80, B = 1: acquisition's BSCH try; N = 80, 144 and 288 at
              B = 18, 18 and 36: the BSCH, SCH/HD and SCH/F groups), on
              soft and on tie-heavy inputs, every bit equal to the plain
              version's on the CPU, each call one launch; then both times
              at each shape (the kernel's device time in torch.profiler
              over 100 calls, and back to back by CUDA events; the plain
              loop on the card by CUDA events over 5 calls, and its
              device operations a call), the kernel's host time a call,
              its latency bound (`viterbi_bound_ms`) and its share of it,
              and the chunk's sums
  3c. sync    the multicarrier sync walk kernel (csrc/sync_walk.cu)
              against its plain version (ops.sync.sync_walk_plain) on
              frontend results of planted signals in seeded noise at the
              benchmark cells' shapes (the full band at 2,097,152 and
              262,144 samples: 96 x 32,241 and 96 x 4,009 scores; 16
              carriers at 2,097,152: 16 x 32,241), on noise rows at those
              shapes and on rows of every window a hit, of every window at
              the adaptive level and of mixed lengths, every position and
              count equal, each call one launch; then at each cell shape
              the kernel's device time in torch.profiler over 100 calls,
              back to back (the scores in L2, as the frontend leaves them)
              and after a 64 MB write that evicts them, its bound (the
              scores' bytes twice at 3.35 TB/s, and the latency of the
              longest row's chain), the plain version's host time, and
              the walk it replaced (each row's `frontend_walk` on the
              pulled scores) with the pull of the score matrix
  4. decode   the main paths through the entry points a user calls, each
              on a planted signal, every launch count set to 0 just before
              and read just after: `tetraear_tpu_torch.ui.cli.main(
              ["decode", f, "--carriers", "16", "--conv", "pallas_bf16"])`,
              the same with "--pfb" (all 96 channels; texts on their
              fftfreq channels), both launching K1 bf16, and with
              "--conv", "pallas" (K1 f32);
              `PfbMulticarrierFrontend(conv="pallas_db")` (K3),
              `MulticarrierFrontend(conv="pallas_of4_bf16")` and
              `"pallas_of4"` (K1-of), the staged
              `StagedMulticarrierFrontend` (K5),
              `RealPairFrontend(num_candidates=64)` on the bench's
              grid-aligned offsets, the gather-form `GatherPfbFrontend`
              and the op-level `pallas_s2d_conv(variant="dt")` and
              `variant="dt_bf16"` (K4, both routes) with the real-pair
              tail, all through `MulticarrierDecoder`.  Every planted SDS
              text must come back on its channel, and each path's kernel
              must have launched; each CLI path launches the sync walk
              once a chunk.  Then, uncounted, the 16-carrier and
              full-band `pallas_bf16` and the `pallas_of4_bf16` frontends
              on the planted signals, and the `pallas_bf16` frontends on
              signals planted at 8 MS/s (16 carriers, K = 5082), 3.2 MS/s
              (full band) and 20 MS/s (16 carriers, K = 12782), give the
              candidates (positions, frames, CRC verdicts) that the same
              frontend gives with the plain bf16 conv
  4b. downlink the ETSI downlink, survey and uplink through the CLI, each
              path with the launch counts set to 0 just before and read
              just after: `downlink --simulate --slots 72` (one multiframe,
              frame 18 included; every planted SCH/F text, the SDS-TL
              text, the group call's CMCE PDUs and the cell identity
              decoded, every row equal to the same command's with
              --device cpu); `downlink FILE --survey 16` on three cells
              planted on carriers 3, 8 and 12 of carrier_grid(16) (each
              identity on its carrier, every CRC passed), then
              `MulticarrierDownlinkReceiver(16)` on the same capture (each
              cell's text; every carrier's decisions equal those made from
              K5's plain version), which must launch K5; `uplink
              --simulate` with and without --continuous (every burst's
              CMCE / SDS decoded, rows equal to --device cpu's)
  4c. operator the operator's commands through the CLI, each path with
              the launch counts set to 0 just before and read just after:
              `listen --iq-file f --no-afc --max-chunks 4 -o out.jsonl
              --no-auto-decrypt` on 20 planted slots (the text in every
              frame, frames from at least 3 chunks, the JSONL equal byte
              for byte to --device cpu's), `listen --synthetic
              --max-chunks 4 --waterfall wf.ppm`, `scan 391.4 393.6
              --iq-file f -f 392.5 --wideband` on utils.synth.planted_scan
              (each planted channel, and no other, TETRA in the top 20),
              which must launch K5, then scan_wideband on the card and on
              the CPU (every channel's decisions equal, powers within
              1e-3 dB); the stepped scan over 5 channels (lines equal to
              --device cpu's); `waterfall` (its rows within 1e-3 dB of
              the CPU's on bins within 60 dB of the peak and every bin's
              amplitude within TOL x its row's peak); a headless `tui
              --max-chunks 4 --duration 5` (its session counts the frames
              `listen` decoded); and a `listen` whose processor fails on
              the card (a CUDA out-of-memory), which must raise
  5. single   the single-carrier receiver and the etsi link on the card,
              plain PyTorch but for the etsi link's Viterbi, the one
              kernel of the table they launch (the launch counts are set
              to 0 before each path and read after it): the
              golden captures clean, noisy_offset, encrypted and the
              chunked long_mixed through the ref-exact `SignalProcessor`
              and `TetraDecoder`, every golden key equal; the CLI's
              `decode --profile ref-compat | ref-exact | etsi` on planted
              captures, each text found; `transmit` -> `EtsiLinkReceiver`
              clean (4 of 4 CRC-ok) and at 12 dB (at least 3 of 4), the
              MAC bits the ones sent
  6. timing   at n = 8,319,936, K = 64, threshold 0.80, with CUDA events:
              each kernel against its plain version, its bound on this
              card and one PyTorch call of the same function (cuDNN's
              `F.conv1d`, TF32 off for f32; bf16 operands and a bf16
              output for the bf16 routes): K1 f32 and bf16, K3, K1-of
              (fold 4) and K4 (dt, dt_bf16) at C2 = 32, (K1 bf16, K3) on
              the filterbank kernel; the 16-carrier (pallas_bf16) and
              full-band (pallas_bf16, pallas_db) frontends' stages,
              end-to-end rate, device busy share (torch.profiler), peak
              memory and host decode; K5 against the plain mixer + FIR
              with the peak memory of both, its FLOP bound beside its
              oscillator floor, with every phase small, and its generic
              path at 8 MS/s; the staged frontend's stages;
              RealPairFrontend(64) and the gather-form full band end to
              end; then each single-carrier
              profile's block demodulator on one 262,144-sample chunk, its
              busy share, the IIR's two filtfilts alone, the host decoder
              on one chunk and the SCH/F Viterbi decode of 1 and 16 blocks;
              then per capture, with its device busy share:
              DownlinkReceiver.receive on one multiframe and its parts,
              one SCH/F group's channel decode, the survey (K5 + etsi
              tail + host walk) at 2.45 M and 8,319,936 samples, and the
              two uplink monitors; then the listen loop per 131,072-sample
              chunk against its 54.6 ms of air with its busy share, one
              `scan --wideband` sweep with its K5 + tail front (also with
              all 95 channels hot) and its host decode, and the stepped
              scan per probed channel with its SignalProcessor
              construction
  7. pod      the pod-scale receive (tetraear_tpu_torch/parallel/), run
              after 4c and before the timing: on captures of C = 96
              channels (carrier_grid(96); the real-pair step on the
              25 kHz-multiple grid) and 8,320,000 samples (real-pair
              8,311,680), SDS texts and downlink cells planted on
              channels 5, 48 and 90: (c) K5 against its plain version
              within TOL at the shard starts (-17,160 and the last shard's
              4,142,840; C = 96 and 48); (a) a world of one rank (nccl,
              (1, 1) mesh): `ShardedReceiver`, `build_sharded_step_fused`,
              `build_sharded_step_realpair` and `ShardedDownlinkReceiver`,
              each path with the launch counts set to 0 just before and
              read just after (K5 on the staged and etsi paths), each text
              and cell decoded on its channel, every sync emitted once,
              the owned interiors equal to the unsharded frontends' and
              MulticarrierDownlinkReceiver.demodulate's (planted channels
              bit-equal, the others >= 0.995, LLRs within 1e-3), and each
              step's time (CUDA events, busy share) beside the unsharded
              frontend on the same block; (b) nccl's answer to 4 ranks on
              the one card, then 4 ranks over gloo, (2, 2) mesh, every
              rank on cuda:0, each launching K5: the gathered results
              equal to (a)'s on owned interiors, best phases equal, and
              each step's time with its exchange share (four ranks on one
              card: not a scaling number); (d) `entry(device)` (counted,
              K5) and `dryrun_multichip(1, "cuda")`
  8. tools    the port's twins of the repo's tools
              (tetraear_tpu_torch/tools/), each path with the launch
              counts set to 0 just before and read just after:
              `sensitivity_sweep` at its defaults (12 slots, 3 seeds, 8
              SNRs) on the card and with --device cpu, every slot's CRC
              verdict equal at every SNR and the curve the JAX slow test
              pins (>= 0.9 at -6 and -12 dB, <= 0.5 at -16 dB), ms per SNR
              point; `make_fixture` (a 48-frame capture, and its bytes
              equal to a second run's); the four capture tools
              (continuous_capture, listen_clear, auto_capture,
              decrypt_capture) on clean.cf32 and encrypted.cf32 and
              continuous_capture on the 48-frame capture, every file they
              write equal to --device cpu's, ms per 262,144-sample chunk;
              `bench_scaling` spawned as a user runs it (one rank over
              nccl through entry.launch), then in a started world of one,
              --profile ref and etsi at the default block and at
              8,320,000 samples a rank, samples/s, each run launching K5,
              and K5 at each run's shape (C = 1 at -12.5 kHz, the block
              plus its halos from start -halo) against its plain version

  9. comm     the communication audit
              (tetraear_tpu_torch/tools/comm_analysis.py): in a started
              world of one (nccl, (1, 1)), with the launch counts set to
              0 just before and read just after, its three steps (fused,
              realpair, etsi) at --scale 8 (1,081,600 samples a shard,
              C = 1), each row printed with the card's name and power
              limit: permute 0, all-reduce 52 / 52 / 16 bytes, the link
              unmeasured, t_compute by CUDA events, K5 launched (etsi);
              K5 at that step's shape (C = 1 at 0 Hz and -25 kHz, start
              -800) against its plain version; then 4 gloo ranks on the
              card, the etsi step on the (2, 2) and (1, 4) meshes at
              --scale 1, every rank's counts by kind, by call, sent and
              gathered equal to the same ranks' on the CPU
  10. bench   the wideband bench (tetraear_tpu_torch/bench.py), run after
              the timing phases: its tier programs and rate
              (`bench._run_tier`) at its defaults, 16 carriers (96 for
              pfb), n = 8,319,936, 6 timed steps (single: 24 on 266,240
              samples), for the tiers fused_pallas_bf16 (K1 bf16), pfb
              (K1 bf16, 192 rows), complex (K5), realpair64, single,
              fused_pallas (K1 f32), fused_pallas_db (K3) and
              fused_pallas_of4_bf16 (K1-of bf16), each with the launch
              counts set to 0 just before and read just after (its kernel,
              and no other, launched once a step), its line held to the
              one-line contract, its samples/s printed with the card's
              name and power limit beside phase 6's time for the same
              frontend; then `python -m tetraear_tpu_torch.bench` with the
              defaults in a process of its own, its one stdout line parsed

The line before the last is a JSON object with each kernel's route,
source, launches in phases 4 to 5, 7, 8, 9 and 10, error, times and bound;
the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import functools
import json
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path


class RefuseReference:
    """A sys.meta_path finder that refuses jax and the JAX package
    `tetraear_tpu` (and everything under them), so that this run proves
    the port imports neither; `tetraear_tpu_torch` is another name."""

    REFUSED = ("jax", "jaxlib", "tetraear_tpu")

    def find_spec(self, name, path=None, target=None):
        if name.partition(".")[0] in self.REFUSED:
            raise ModuleNotFoundError(
                f"{name} is refused: the port must not import it", name=name)
        return None


def refuse_reference() -> None:
    loaded = [m for m in sys.modules
              if m.partition(".")[0] in RefuseReference.REFUSED]
    if loaded:
        raise SystemExit(f"refused modules already imported: {loaded[:5]}")
    sys.meta_path.insert(0, RefuseReference())


refuse_reference()

BENCH_N = 8_319_936          # bench.py's n per block
RAGGED_N = 1_000_007
TOL = 4e-6                   # x max|plain|: f32 sum order only (K5:
                             # the 121-tap FIR's, plus its oscillator's
                             # <= 2 ulp against torch.sin / torch.cos)
BF16_TOL = 1e-2              # x max|f32 plain|: bf16 operand rounding


def tc_tol(k2) -> float:
    """The tensor-core route's bound for s2d weights k2 (C2, 2D, Lp): TOL
    up to K = 2D * Lp = 1600, the main path's depth, then TOL * K / 1600:
    each of the K / 16 MMA steps truncates its f32 sum, a bias that adds
    up with depth (K = 5082 at 8 MS/s: 8.05e-6 x max|plain| measured)."""
    return TOL * max(1.0, k2.shape[1] * k2.shape[2] / 1600)
PEAK_BF16 = 989e12           # dense bf16 tensor cores, FLOP/s (H100 SXM)
PEAK_F32 = 67e12             # f32 outside the tensor cores, FLOP/s
PEAK_BYTES = 3.35e12         # HBM3, bytes/s
PLANTED = (3, 8, 12)         # grid indices of carrier_grid(16)
K5_START = 10_000_000        # a start index where |phase| reaches ~5e6 rad
# instructions one K5 oscillator issues at the specialised shape: the
# mixing loop of its SASS (cuobjdump -sass, nvcc 12.9, sm_90a) holds 452
# for a thread's 11 samples of one carrier (phase, fp64 reduction,
# polynomials, correction, quarter turn, complex product, store)
K5_OSC_INSTRUCTIONS = 41
# (frontend, MS/s) of the decision checks beyond K = 2D * Lp = 1600
DECISION_RATES = ((16, 8.0), ("pfb", 3.2), (16, 20.0))
KERNELS = {                  # wrapper -> (source, TPU kernel it replaces)
    "s2d_conv": ("tetraear_tpu_torch/csrc/s2d_conv.cu",
                 "tetraear_tpu/ops/pallas/s2d_conv.py:71"),
    "s2d_conv_bf16": ("tetraear_tpu_torch/csrc/s2d_conv_tc.cu",
                      "tetraear_tpu/ops/pallas/s2d_conv.py:71"),
    "s2d_conv_of": ("tetraear_tpu_torch/csrc/s2d_conv.cu",
                    "tetraear_tpu/ops/pallas/s2d_conv.py:371"),
    "s2d_conv_of_bf16": ("tetraear_tpu_torch/csrc/s2d_conv_tc.cu",
                         "tetraear_tpu/ops/pallas/s2d_conv.py:371"),
    "s2d_conv_db": ("tetraear_tpu_torch/csrc/s2d_conv_db.cu",
                    "tetraear_tpu/ops/pallas/s2d_conv.py:162"),
    "s2d_conv_dt": ("tetraear_tpu_torch/csrc/s2d_conv_dt.cu",
                    "tetraear_tpu/ops/pallas/s2d_conv.py:108"),
    "s2d_conv_dt_bf16": ("tetraear_tpu_torch/csrc/s2d_conv_tc.cu",
                         "tetraear_tpu/ops/pallas/s2d_conv.py:108"),
    "fused_channelize": ("tetraear_tpu_torch/csrc/fused_channelize.cu",
                         "tetraear_tpu/ops/pallas/fused_channelize.py:59"),
    "viterbi": ("tetraear_tpu_torch/csrc/viterbi.cu",
                "none: tetraear_tpu/ops/viterbi.py:141 is a lax.scan"),
    "sync_walk": ("tetraear_tpu_torch/csrc/sync_walk.cu",
                  "none: the JAX package's TetraDecoder.find_sync walks "
                  "on the host"),
}
CLI_CHUNK = 256 * 1024       # decode --chunk-size's default
# the sync walk's latency bound, in clocks: a row's two reads of its
# scores (HBM ~400 each, the cuda guide), then one dependent step of the
# walk a 1,024 windows or an accept (shared load ~20, ballot, shuffle,
# __ffs and the compare, ~4 each)
SYNC_LOAD_CLOCKS = 2 * 400
SYNC_STEP_CLOCKS = 20 + 5 * 4
# (N, B) of the downlink cell's Viterbi calls a multiframe: acquisition's
# BSCH try, then the BSCH, SCH/HD and SCH/F groups of its 72 slots
VITERBI_SHAPES = ((80, 1), (80, 18), (144, 18), (288, 36))
# the Viterbi kernel's latency bound, in clocks of one dependent step of
# its two serial chains and of its one DRAM round trip, from the latencies
# the cuda guide gives (shared memory ~20 clocks, which a shuffle is taken
# at, as it crosses the same crossbar; HBM ~400) and the CUDA C++
# Programming Guide's ~4 clocks a dependent arithmetic instruction
VITERBI_ACS_CLOCKS = 20 + 3 * 4     # shuffle, add, compare, select
VITERBI_TRACE_CLOCKS = 3 * 4        # shift by the state, mask, merge
VITERBI_LOAD_CLOCKS = 400           # the soft values into shared memory


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
def _s2d_kernel(num_carriers, device, msps: float = 2.4) -> tuple:
    """(s2d kernel, gc, L, D) of the frontend for carrier_grid(num_carriers)
    or, for "pfb", the full-band filterbank's, at `msps` MS/s; designed
    once per run."""
    from tetraear_tpu_torch.config import ReceiverConfig
    from tetraear_tpu_torch.models.multicarrier import (
        MulticarrierFrontend, PfbMulticarrierFrontend)
    from tetraear_tpu_torch.ops.channelizer import carrier_grid
    cfg = ReceiverConfig(sample_rate_hz=msps * 1e6)
    if num_carriers == "pfb":
        mc = PfbMulticarrierFrontend.from_config(cfg, device=device,
                                                 conv="s2d")
    else:
        mc = MulticarrierFrontend.from_offsets(carrier_grid(num_carriers),
                                               cfg, device=device, conv="s2d")
    return mc.kernel_s2d, mc.gc, mc.L, mc.decim


def _case(num_carriers, n: int, seed: int, device, msps: float = 2.4):
    """(x, s2d kernel, gc, L, D) on the card: complex noise * 0.1 and the
    frontend's composite kernel for carrier_grid(num_carriers), or the
    full-band filterbank's for "pfb", at `msps` MS/s."""
    import torch
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(n, dtype=torch.complex64, device=device,
                    generator=gen) * 0.1
    return (x,) + _s2d_kernel(num_carriers, device, msps)


def _held(tag: str, name: str, got, want, bound: float) -> float:
    """max|got - want| within bound x max|want|, or the run fails."""
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    ok = got.shape == want.shape and err <= bound * scale
    print(f"[kernel] {tag}: max|{name}-plain| = {err:.3e} = "
          f"{err / scale:.3e} x max|plain| ({scale:.4f}), bound {bound:.4g} x "
          f"max|plain| = {bound * scale:.3e}: {'ok' if ok else 'FAIL'}")
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
    # 767, the first ~77 windows straddle the left zero pad); bf16 runs
    # on the tensor cores (s2d_conv_bf16), also from one sample into the
    # input's storage and at other rates: 8 MS/s (2D = 66: 4-byte A
    # loads, weights streamed through shared memory), the full band at
    # 3.2 MS/s (D = 13) and 16 carriers at 20 MS/s (2D = 166: a window
    # too large for the register prefetch)
    for num_carriers, n, start, msps in (
            (16, BENCH_N, 0, 2.4), (96, RAGGED_N, 0, 2.4),
            ("pfb", BENCH_N, 0, 2.4), (16, RAGGED_N, 1, 2.4),
            (16, RAGGED_N, 1, 8.0), ("pfb", RAGGED_N, 0, 3.2),
            (16, 400_009, 0, 20.0)):
        x, k2, gc, L, decim = _case(num_carriers, n + start, 1, device, msps)
        x = x[start:]
        f32 = kc.s2d_conv_plain(x, k2, gc, L, decim)
        tc = kc.tc_pack_k1(k2)
        for bf16 in ((False, True) if start == 0 and msps == 2.4
                     else (True,)):
            name = "s2d_conv_bf16" if bf16 else "s2d_conv"
            got = _launched(name, lambda: kc.s2d_conv(
                x, k2, gc, L, decim, bf16=bf16, tc=tc))
            want = (kc.s2d_conv_plain(x, k2, gc, L, decim, bf16=True)
                    if bf16 else f32)
            tag = (f"K1 {num_carriers} {msps} MS/s C2={k2.shape[0]} "
                   f"2D={k2.shape[1]} gc={gc} n={n} start={start} "
                   f"{'bf16' if bf16 else 'f32'}"
                   + (f" (tensor cores: {tc.rows} rows, {tc.tile_m} "
                      f"positions, fold {tc.fold}, {tc.kchunk} of "
                      f"{tc.packed.shape[1]} k-steps resident)"
                      if bf16 else ""))
            worst[name] = max(worst[name], _held(
                tag, "K1", got, want, tc_tol(k2) if bf16 else TOL))
            if bf16:
                _held(tag + " vs f32", "K1", got, f32, BF16_TOL)
        del x, got, want, f32
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
    # K1-of against the folded plain version (f32 sum order) and, for
    # bf16, against the f32 result; fold 3 at 1.8 MS/s (D = 7) takes
    # 4-byte A loads
    for fold, n, msps in ((4, BENCH_N, 2.4), (6, RAGGED_N, 2.4),
                          (1, RAGGED_N, 2.4), (3, RAGGED_N, 1.8)):
        x, k2, gc, L, decim = _case(16, n, 3, device, msps)
        k_of = torch.as_tensor(fused.fold_s2d_kernel(k2.cpu().numpy(), fold),
                               device=device)
        f32 = kc.s2d_conv_of_plain(x, k_of, gc, L, decim, fold)
        tc = kc.tc_pack(k_of, fold)
        for bf16 in ((False, True) if msps == 2.4 else (True,)):
            name = "s2d_conv_of_bf16" if bf16 else "s2d_conv_of"
            got = _launched(name, lambda: kc.s2d_conv_of(
                x, k_of, gc, L, decim, fold, bf16=bf16, tc=tc))
            want = kc.s2d_conv_of_plain(x, k_of, gc, L, decim, fold,
                                        bf16=bf16)
            tag = (f"K1-of fold={fold} {msps} MS/s n={n} "
                   f"{'bf16' if bf16 else 'f32'}")
            worst[name] = max(worst[name], _held(
                tag, "K1-of", got, want, tc_tol(k2) if bf16 else TOL))
            if bf16:
                _held(tag + " vs f32", "K1-of", got, f32, BF16_TOL)
        del x, got, want, f32
    worst.update(kernel_k4(device))
    worst["fused_channelize"] = max(kernel_k5(device),
                                    kernel_k5_scan(device))
    return worst


def _device_ops(fn) -> int:
    """Device operations (kernels and copies) of one call of fn, from a
    torch.profiler trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA)


def _max_sm_mhz() -> float:
    """The card's maximum SM clock, MHz, as nvidia-smi reports it."""
    return float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True,
        text=True).stdout.split()[0])


def viterbi_bound_ms(n: int, mhz: float) -> float:
    """The Viterbi kernel's latency bound at N = n trellis steps, whatever
    the batch (the grid spreads code blocks over the SMs): the soft
    values' DRAM round trip, then n add-compare-select steps and n
    traceback steps, each waiting on the last, at `mhz`."""
    clocks = (VITERBI_LOAD_CLOCKS
              + n * (VITERBI_ACS_CLOCKS + VITERBI_TRACE_CLOCKS))
    return clocks / (mhz * 1e6) * 1e3


def phase_viterbi(device, card: str) -> dict:
    """3b: the Viterbi kernel against its plain version at VITERBI_SHAPES
    (module docstring); -> its chunk's times, its bound and the bits that
    differed."""
    import numpy as np
    import torch
    from tetraear_tpu_torch.ops import viterbi as vit
    rng = np.random.default_rng(18)
    wrong = 0
    mhz = _max_sm_mhz()
    chunk = {"ms": 0.0, "plain_ms": 0.0, "host_ms": 0.0, "bound_ms": 0.0}
    for n, b in VITERBI_SHAPES:
        soft = rng.standard_normal((b, 4 * n)).astype(np.float32)
        ties = (np.sign(soft) * (rng.random(soft.shape) > 0.3)).astype(
            np.float32)
        for x in (soft, ties):
            got = _launched("viterbi", lambda: vit.viterbi_decode(
                torch.as_tensor(x, device=device), n))
            want = vit.viterbi_decode_plain(torch.as_tensor(x), n)
            wrong += int((got.cpu() != want).sum())
        xd = torch.as_tensor(soft, device=device)

        def kernel():
            return vit.viterbi_decode(xd, n)

        def plain():
            return vit.viterbi_decode_plain(xd, n)
        p1 = _time_ms(plain, 5, 1)
        k1 = _device_busy_ms(kernel, 100)[0]
        k2 = _device_busy_ms(kernel, 100)[0]
        p2 = _time_ms(plain, 5, 1)
        events_ms = _time_ms(kernel, 200, 10)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            kernel()
        host_ms = (time.perf_counter() - t0) / 200 * 1e3
        torch.cuda.synchronize()
        ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
        bound_ms = viterbi_bound_ms(n, mhz)
        print(f"[viterbi] {card}: N = {n}, B = {b}: kernel {ms:.4f} ms "
              f"({k1:.4f}, {k2:.4f}; device time in torch.profiler, 100 "
              f"calls; {ms / n * 1e6:.1f} ns a trellis step); latency "
              f"bound {bound_ms:.4f} ms = {bound_ms / ms:.1%} of it; back to "
              f"back {events_ms:.4f} ms a call (CUDA events, 200 calls), "
              f"host {host_ms:.4f} ms a call, 1 launch "
              f"({_device_ops(kernel)} device op); plain on the card "
              f"{plain_ms:.3f} ms ({p1:.3f}, {p2:.3f}; CUDA events, 5 "
              f"calls), {_device_ops(plain)} device ops a call")
        chunk["ms"] += ms
        chunk["plain_ms"] += plain_ms
        chunk["host_ms"] += host_ms
        chunk["bound_ms"] += bound_ms
    if wrong:
        fail("viterbi", f"{wrong} bits differ from the plain version's")
    by = (f"latency: {VITERBI_LOAD_CLOCKS} + N x ({VITERBI_ACS_CLOCKS} + "
          f"{VITERBI_TRACE_CLOCKS}) clocks at {mhz:.0f} MHz")
    print(f"[viterbi] {card}: the cell's four calls a multiframe: kernel "
          f"{chunk['ms']:.4f} ms (host {chunk['host_ms']:.4f} ms), latency "
          f"bound {chunk['bound_ms']:.4f} ms ({by}) = "
          f"{chunk['bound_ms'] / chunk['ms']:.1%} of it, plain "
          f"{chunk['plain_ms']:.3f} ms; every bit equal, soft and "
          f"tie-heavy")
    return {"max_abs_err": 0.0, "ms": chunk["ms"],
            "plain_ms": chunk["plain_ms"], "bound_ms": chunk["bound_ms"],
            "bound_by": by, "library_ms": None}


def _sync_cases(device) -> list:
    """(tag, scores, counts) on the card for phase 3c: frontend results of
    planted signals in seeded noise at the cells' shapes, noise rows at
    those shapes, and rows of every window a hit, of every window at the
    adaptive level and of mixed lengths."""
    import numpy as np
    import torch
    from tetraear_tpu_torch.models.multicarrier import build_frontend
    from tetraear_tpu_torch.ops.channelizer import carrier_grid
    from tetraear_tpu_torch.utils.synth import planted_pfb, planted_wideband
    rng = np.random.default_rng(20)
    cases = []
    for tag, pfb, planted, n in (
            ("full band, 2,097,152 samples", True, planted_pfb, 2_097_152),
            ("16 carriers, 2,097,152 samples", False,
             lambda: planted_wideband(PLANTED), 2_097_152),
            ("full band, 262,144 samples", True, planted_pfb, 262_144)):
        fe = build_frontend("pallas_bf16", device=device, pfb=pfb,
                            offsets_hz=None if pfb else carrier_grid(16))
        x = (rng.standard_normal(2 * n).astype(np.float32) * 0.01).view(
            np.complex64)
        sig = planted()[0][:n]
        x[:len(sig)] += sig
        res = fe(x)
        cases.append((tag, res.sync_corr, res.count))
        r, w = res.sync_corr.shape
        k = np.maximum(rng.binomial(22, 0.5, (r, w)),
                       rng.binomial(22, 0.5, (r, w)))
        cases.append((f"noise rows {r} x {w}",
                      torch.as_tensor((k / 22).astype(np.float32),
                                      device=device), res.count))
    w = 40_000
    rows = np.full((3, w), np.float32(0.5))
    rows[0] = 1.0
    rows[1] = 0.80
    rows[2, 7::249] = 0.95
    cases.append(("every window a hit, at 0.80, hits 249 apart",
                  torch.as_tensor(rows, device=device),
                  torch.full((3,), (w + 21) // 2 + 1, dtype=torch.int32,
                             device=device)))
    counts = np.array([0, 1, 11, 12, 13, 900, 16_131, 20_011], np.int32)
    k = rng.binomial(22, 0.55, (len(counts), w))
    cases.append(("mixed lengths", torch.as_tensor(
        (k / 22).astype(np.float32), device=device),
        torch.as_tensor(counts, device=device)))
    return cases


def sync_bound_ms(corr, count, accepted, mhz: float) -> tuple:
    """(bound ms, "bytes" | "latency", bytes ms, latency ms) of the sync
    walk on scores `corr` (R, W): the scores read twice at PEAK_BYTES, or
    the longest row's chain (its reads, then a step for every 1,024
    windows and every accept) at `mhz`."""
    import numpy as np
    rows, width = corr.shape
    bytes_ms = 2 * rows * width * 4 / PEAK_BYTES * 1e3
    nsym = np.maximum(count.astype(np.int64) - 1, 0)
    valid = np.clip(2 * nsym - 21, 0, width)
    steps = int((accepted + -(-valid // 1024)).max()) if rows else 0
    latency_ms = (SYNC_LOAD_CLOCKS + steps * SYNC_STEP_CLOCKS) / (
        mhz * 1e6) * 1e3
    return ((bytes_ms, "bytes", bytes_ms, latency_ms) if bytes_ms >= latency_ms
            else (latency_ms, "latency", bytes_ms, latency_ms))


def phase_sync_walk(device, card: str) -> dict:
    """3c: the sync walk kernel against its plain version (module
    docstring); -> its times at the full band's quiet shape, with its
    bound."""
    import numpy as np
    import torch
    from tetraear_tpu_torch.core.decoder import TetraDecoder
    from tetraear_tpu_torch.ops import sync
    from tetraear_tpu_torch.ops.kernels import sync_walk as ksw
    mhz = _max_sm_mhz()
    cases = _sync_cases(device)
    wrong = 0
    for tag, corr, count in cases:
        got = _launched("sync_walk", lambda: sync.sync_walk(corr, count))
        want = sync.sync_walk_plain(corr, count)
        same = all(torch.equal(a.cpu(), b) for a, b in zip(got, want))
        wrong += not same
        print(f"[sync] {tag}: {tuple(corr.shape)}, {int(want[1].sum())} "
              f"positions, kernel {'equal' if same else 'DIFFERS'}")
    if wrong:
        fail("sync", f"{wrong} cases differ from the plain version")
    flush = torch.empty(64 * 2**20 // 4, dtype=torch.float32, device=device)
    out = None
    for tag, corr, count in cases[:6:2]:
        def kernel():
            return ksw.sync_walk(corr, count)

        def cold():
            flush.zero_()
            return ksw.sync_walk(corr, count)
        warm_ms = _device_busy_ms(kernel, 100)[0]
        cold_ms = next((ms for name, ms in _device_busy_ms(cold, 100)[1]
                        if "sync_walk" in name), None)
        events_ms = _time_ms(kernel, 200, 10)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            kernel()
        host_ms = (time.perf_counter() - t0) / 200 * 1e3
        torch.cuda.synchronize()
        cpu_corr, cpu_count = corr.cpu(), count.cpu()
        t0 = time.perf_counter()
        _, acc = sync.sync_walk_plain(cpu_corr, cpu_count)
        plain_ms = (time.perf_counter() - t0) * 1e3
        # what the decode did before: pull the scores, walk every row
        dec = TetraDecoder(device="cpu")
        t0 = time.perf_counter()
        s = corr.cpu().numpy()
        pull_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        for r, c in enumerate(cpu_count.numpy()):
            nbits = 2 * max(int(c) - 1, 0)
            dec.frontend_walk(np.zeros(nbits, np.uint8),
                              np.zeros(nbits // 2, np.int64),
                              s[r, :max(0, nbits - 21)])
        cascade_ms = (time.perf_counter() - t0) * 1e3
        bound_ms, by, bytes_ms, latency_ms = sync_bound_ms(
            s, cpu_count.numpy(), acc.numpy(), mhz)
        print(f"[sync] {card}: {tag} {tuple(corr.shape)}: kernel "
              f"{warm_ms:.4f} ms with the scores in L2, "
              + (f"{cold_ms:.4f} ms after a 64 MB write"
                 if cold_ms is not None else "cold not measured")
              + f" (device time in torch.profiler, 100 calls); back to back "
              f"{events_ms:.4f} ms (CUDA events), host {host_ms:.4f} ms a "
              f"call, 1 launch ({_device_ops(kernel)} device op); bound "
              f"{bound_ms:.4f} ms by {by} (bytes: the scores twice "
              f"{bytes_ms:.4f} ms, once {bytes_ms / 2:.4f}; latency "
              f"{latency_ms:.4f} ms); plain version {plain_ms:.2f} ms on "
              f"the host; replaced: the score pull {pull_ms:.2f} ms and "
              f"each row's frontend_walk {cascade_ms:.2f} ms")
        if out is None:
            ms = cold_ms if cold_ms is not None else warm_ms
            out = {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
                   "bound_ms": bound_ms,
                   "bound_by": f"{by}: 2 x R x W x 4 B at 3.35 TB/s, or "
                   f"{SYNC_LOAD_CLOCKS} + steps x {SYNC_STEP_CLOCKS} clocks "
                   f"at {mhz:.0f} MHz", "library_ms": None}
    return out


def kernel_k4(device) -> dict:
    """K4 against the plain conv: dt (CUDA cores) within the f32
    sum-order bound; dt_bf16 (the tensor-core kernel, unfolded, its own
    tap-major order) within tc_tol of the plain bf16 conv and BF16_TOL of
    the f32 result.  The filterbank kernel's 192 rows and pad_l = 767 at
    the ragged n."""
    from tetraear_tpu_torch.ops.kernels import s2d_conv as kc
    worst = {"s2d_conv_dt": 0.0, "s2d_conv_dt_bf16": 0.0}
    for num_carriers, n in ((16, BENCH_N), ("pfb", RAGGED_N)):
        x, k2, gc, L, decim = _case(num_carriers, n, 5, device)
        f32 = kc.s2d_conv_plain(x, k2, gc, L, decim)
        tc = kc.tc_pack_dt(k2)
        for bf16 in (False, True):
            name = "s2d_conv_dt_bf16" if bf16 else "s2d_conv_dt"
            got = _launched(name, lambda: kc.s2d_conv_dt(
                x, k2, gc, L, decim, bf16=bf16, tc=tc))
            want = (kc.s2d_conv_plain(x, k2, gc, L, decim, bf16=True)
                    if bf16 else f32)
            tag = (f"K4 {num_carriers} C2={k2.shape[0]} gc={gc} n={n} "
                   + (f"dt_bf16 (tensor cores: {tc.rows} rows, {tc.tile_m} "
                      f"positions)" if bf16 else "dt"))
            worst[name] = max(worst[name], _held(
                tag, "K4", got, want, tc_tol(k2) if bf16 else TOL))
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
    the same f32 phases: the FIR's f32 sum order plus the <= 2 ulp of
    K5's oscillator against torch.sin / torch.cos, within TOL x
    max|plain|.
    Both are also held against a float64 oracle of the same phases on
    256 outputs, which says which of the two is off if they disagree.
    The staged frontend's 121 taps at 2.4 MS/s run the specialised path,
    its 397 taps at 8 MS/s (D = 33) the generic one."""
    import numpy as np
    import torch
    from tetraear_tpu_torch.config import ReceiverConfig
    from tetraear_tpu_torch.models.realpair import staged_state
    from tetraear_tpu_torch.ops.channelizer import carrier_grid
    from tetraear_tpu_torch.ops.kernels import fused_channelize as k5
    worst = 0.0
    for msps, n, start in ((2.4, BENCH_N, 0), (2.4, RAGGED_N, K5_START),
                           (2.4, RAGGED_N, 2**24 + 12_345),
                           (8.0, RAGGED_N, K5_START)):
        state = staged_state(carrier_grid(16),
                             ReceiverConfig(sample_rate_hz=msps * 1e6))
        offs = torch.as_tensor(state.offsets_hz, device=device)
        taps = torch.as_tensor(state.taps_d, device=device)
        fs = state.sample_rate_hz
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
        path = ("specialised" if (len(taps), state.decim) == k5.SPECIALISED
                else "generic")
        tag = (f"K5 16 carriers {msps} MS/s L={len(taps)} D={state.decim} "
               f"({path}, {k5.tile_outputs(len(taps), state.decim)} outputs "
               f"a tile) n={n} start={start}")
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


def kernel_k5_scan(device) -> float:
    """K5 at the carrier counts `scan --wideband` gives it: C = len(hot),
    offsets the hot channels' multiples of 25 kHz from a centre that is
    one too, n = usable = 1,044,480 (scanner.py): one carrier, the three
    planted channels of phase 4c's capture, and every channel of the
    sweep (95 at 2.4 MS/s), each within TOL x max|plain| of its plain
    version and against the float64 oracle on 256 outputs."""
    import numpy as np
    import torch
    from tetraear_tpu_torch.config import ReceiverConfig
    from tetraear_tpu_torch.models.realpair import staged_state
    from tetraear_tpu_torch.ops.kernels import fused_channelize as k5
    worst = 0.0
    sweep = scan_channels_hz()
    for offsets in (np.array([-300e3]), np.array(SCAN_OFFSETS), sweep):
        state = staged_state(offsets.astype(np.float32), ReceiverConfig())
        offs = torch.as_tensor(state.offsets_hz, device=device)
        taps = torch.as_tensor(state.taps_d, device=device)
        gen = torch.Generator(device=device).manual_seed(11)
        x = torch.randn(SCAN_USABLE, dtype=torch.complex64, device=device,
                        generator=gen) * 0.1
        got = _launched("fused_channelize", lambda: k5.fused_channelize(
            x, offs, state.sample_rate_hz, state.decim, taps))
        want = k5.fused_channelize_plain(x, offs, state.sample_rate_hz,
                                         state.decim, taps)
        m_idx = np.random.default_rng(len(offs)).choice(got.shape[1], 256,
                                                        replace=False)
        oracle = _k5_oracle(x, offs, taps, state.sample_rate_hz,
                            state.decim, 0, m_idx)
        err = np.abs(got[:, m_idx].cpu().numpy() - oracle).max()
        lo, hi = offs.min().item() / 1e3, offs.max().item() / 1e3
        tag = (f"K5 scan sweep C={len(offs)} (offsets {lo:+.0f}..{hi:+.0f} "
               f"kHz) n={SCAN_USABLE}")
        print(f"[kernel] {tag}: on 256 outputs max|K5-f64 oracle| = "
              f"{err:.3e}")
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


def _cli(argv: list) -> int:
    """The port's CLI main on argv, the root logger put back as it was
    after it (main sets up its per-run log files, in TETRAEAR_TPU_LOG_DIR,
    and a console handler)."""
    import logging
    from tetraear_tpu_torch.ui.cli import main
    root = logging.getLogger()
    saved = root.handlers[:], root.level
    try:
        return main(argv)
    finally:
        for h in root.handlers:
            if h not in saved[0]:
                h.close()
        root.handlers[:] = saved[0]
        root.setLevel(saved[1])


def _cli_run(tag: str, argv: list, x, want: dict) -> None:
    import numpy as np
    with tempfile.TemporaryDirectory() as tmp:
        iq = Path(tmp) / "planted.cf32"
        out = Path(tmp) / "planted_frames.jsonl"
        # .cf32: interleaved float32 I/Q
        np.asarray(x, np.complex64).view(np.float32).tofile(iq)
        rc = _cli(["decode", str(iq), *argv, "-o", str(out)])
        got = _texts([map(json.loads, out.read_text().splitlines())])
    print(f"[decode] {tag}: cli exit {rc}")
    if rc != 0:
        fail("decode", f"{tag}: cli exited {rc}")
    _check_texts(tag, want, got)


def _same_candidates(tag: str, mc, x, rows) -> None:
    """mc(x) through its kernel and the same frontend with the plain bf16
    conv give equal candidates on the planted rows: validity, positions,
    frame bits and CRC verdicts (uncounted launches)."""
    import numpy as np
    import torch
    from tetraear_tpu_torch.ops.kernels import s2d_conv as kc
    x = torch.as_tensor(x, device=mc.device)
    args = (mc.gc, mc.L, mc.decim)
    out = (kc.s2d_conv_of_plain(x, mc.kernel_of, *args, mc.fold, bf16=True)
           if mc.fold else
           kc.s2d_conv_plain(x, mc.kernel_s2d, *args, bf16=True))
    c = out.shape[0] // 2
    plain = mc.candidates(*mc.demod((out[:c], out[c:])))
    got = mc(x)
    fields = ("cand_valid", "cand_pos", "frame_bits", "crc_ok")
    a = {f: getattr(got, f).cpu().numpy() for f in fields}
    b = {f: getattr(plain, f).cpu().numpy() for f in fields}
    same = True
    for r in rows:
        va, vb = a["cand_valid"][r], b["cand_valid"][r]
        same &= bool(np.array_equal(va, vb)) and all(
            np.array_equal(a[f][r][va], b[f][r][vb]) for f in fields[1:])
    crc_ok = (a["crc_ok"] & a["cand_valid"])[list(rows)]
    print(f"[decode] {tag}: candidates on planted rows {sorted(rows)} "
          f"({int(a['cand_valid'][list(rows)].sum())} valid, "
          f"{int(crc_ok.sum())} CRC-ok) "
          f"{'equal' if same else 'DIFFER'} to the plain bf16 conv's")
    if not same:
        fail("decode", f"{tag}: candidates differ from the plain bf16 conv's")
    if not crc_ok.any(axis=-1).all():
        fail("decode", f"{tag}: a planted row has no CRC-ok candidate")


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

    for tag, argv, x, want, wrapper in (
            ("cli 16 carriers pallas_bf16",
             ["--carriers", "16", "--conv", "pallas_bf16"], x16, want16,
             "s2d_conv_bf16"),
            ("cli --pfb pallas_bf16",
             ["--carriers", "16", "--pfb", "--conv", "pallas_bf16"], xpfb,
             wantpfb, "s2d_conv_bf16"),
            ("cli 16 carriers pallas (f32)",
             ["--carriers", "16", "--conv", "pallas"], x16, want16,
             "s2d_conv")):
        counts = _path(tag, wrapper, lambda: _cli_run(tag, argv, x, want))
        chunks = -(-len(x) // CLI_CHUNK)
        if counts["sync_walk"] != chunks:
            fail("decode", f"{tag}: {counts['sync_walk']} sync walk "
                 f"launches for {chunks} chunks")
        add(counts)

    def module_run(tag, mc, x, num_channels, want):
        frames = MulticarrierDecoder(num_channels,
                                     device=device).decode(mc(x))
        _check_texts(tag, want, _texts(frames))

    pfb = PfbMulticarrierFrontend.from_config(device=device,
                                              conv="pallas_db")
    add(_path("PfbMulticarrierFrontend pallas_db", "s2d_conv_db",
              lambda: module_run("pfb pallas_db", pfb, xpfb, 96, wantpfb)))
    of4 = {}
    for conv, wrapper in (("pallas_of4_bf16", "s2d_conv_of_bf16"),
                          ("pallas_of4", "s2d_conv_of")):
        of4[conv] = mc = MulticarrierFrontend.from_offsets(
            carrier_grid(16), device=device, conv=conv)
        add(_path(f"MulticarrierFrontend {conv}", wrapper,
                  lambda: module_run(f"16 carriers {conv}", mc, x16, 16,
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
    mc = of4["pallas_of4"]

    def dt_run(variant):
        # the op-level entry point of K4, then the real-pair tail
        x = torch.as_tensor(x16, device=device)
        out = pallas_s2d_conv(x, mc.kernel_s2d, mc.gc, mc.L, mc.decim,
                              variant=variant)
        res = _demod_from_pair(out[:16], out[16:], mc.sps,
                               z_rot=(mc.z_cos, mc.z_sin))
        frames = MulticarrierDecoder(16, device=device).decode(
            mc.candidates(res.bits, res.sync_corr, res.count))
        _check_texts(f"16 carriers pallas_s2d_conv {variant}", want16,
                     _texts(frames))
    for variant, wrapper in (("dt", "s2d_conv_dt"),
                             ("dt_bf16", "s2d_conv_dt_bf16")):
        add(_path(f"pallas_s2d_conv(variant='{variant}') + real-pair tail",
                  wrapper, lambda: dt_run(variant)))
    # the tensor-core route's decisions against the plain bf16 conv's,
    # at the main path's depth and beyond K = 1600
    _same_candidates("16 carriers pallas_bf16", MulticarrierFrontend.
                     from_offsets(carrier_grid(16), device=device,
                                  conv="pallas_bf16"), x16, want16)
    _same_candidates("full band pallas_bf16", PfbMulticarrierFrontend.
                     from_config(device=device, conv="pallas_bf16"), xpfb,
                     wantpfb)
    _same_candidates("16 carriers pallas_of4_bf16", of4["pallas_of4_bf16"],
                     x16, want16)
    for kind, msps in DECISION_RATES:
        fe, x, want = _planted_frontend(kind, msps, device)
        k2 = fe.kernel_s2d
        _same_candidates(f"{'full band' if kind == 'pfb' else '16 carriers'}"
                         f" pallas_bf16 at {msps} MS/s (K = "
                         f"{k2.shape[1] * k2.shape[2]})", fe, x, want)
    return launches


def _planted_frontend(kind, msps: float, device):
    """(the `pallas_bf16` frontend at `msps` MS/s, its planted signal,
    {row: planted text}): texts on grid indices PLANTED of
    carrier_grid(16), or ("pfb") on three channels of the full band."""
    from tetraear_tpu_torch.config import ReceiverConfig
    from tetraear_tpu_torch.models.multicarrier import (
        MulticarrierFrontend, PfbMulticarrierFrontend)
    from tetraear_tpu_torch.ops.channelizer import carrier_grid
    from tetraear_tpu_torch.utils.synth import planted_pfb, planted_wideband
    cfg = ReceiverConfig(sample_rate_hz=msps * 1e6)
    if kind == "pfb":
        x, want = planted_pfb(sample_rate_hz=cfg.sample_rate_hz)
        return (PfbMulticarrierFrontend.from_config(cfg, device=device,
                                                    conv="pallas_bf16"),
                x, want)
    x, want = planted_wideband(PLANTED, sample_rate_hz=cfg.sample_rate_hz)
    return (MulticarrierFrontend.from_offsets(carrier_grid(16), cfg,
                                              device=device,
                                              conv="pallas_bf16"), x, want)


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
    kernels by device time; (None, []) if the trace holds no device time.
    The device-side copies of the program's chunk spans (`tetra.*`, which
    every multicarrier frontend enters) are no operation."""
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
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.key.startswith("tetra.")]
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
    dec = MulticarrierDecoder(rows, device=x.device)
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


def _bound(flops: float, nbytes: float, peak: float) -> tuple:
    """(ms, "operations" | "bytes"): the least time this card could take,
    the operations at `peak` FLOP/s or the bytes at PEAK_BYTES."""
    ops_ms, bytes_ms = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return ((ops_ms, "operations") if ops_ms >= bytes_ms
            else (bytes_ms, "bytes"))


def _conv_work(x, kernel, fold: int, decim: int) -> tuple:
    """(FLOP, bytes) of the s2d conv of x with `kernel` (rows, 2D, taps):
    2 x rows x 2D x taps per (folded) output position; x read once, the
    f32 kernel read once, the (rows / fold, ceil(N/D)) f32 output written
    once."""
    rows, ich, taps = kernel.shape
    m_out = -(-x.shape[0] // decim)
    m_pos = -(-m_out // fold)
    flops = 2.0 * rows * ich * taps * m_pos
    nbytes = 8.0 * x.shape[0] + 4.0 * kernel.numel() + 4.0 * rows // fold * m_out
    return flops, nbytes


def _library_conv(x, kernel, gc: int, L: int, decim: int, fold: int,
                  dtype):
    """One cuDNN F.conv1d (stride fold) over the (1, 2D, W) view of x,
    made contiguous in `dtype` beforehand, with the kernel in `dtype`:
    the same contraction as K1 / K1-of (bf16: bf16 operands, a bf16
    output).  The port never calls it; it is the yardstick."""
    import torch.nn.functional as F
    from tetraear_tpu_torch.ops.kernels import s2d_conv as kc
    n = x.shape[0]
    m_out = -(-n // decim)
    pad_l = L - 1 - gc
    wr = -(-m_out // fold)
    total = max(((wr - 1) * fold + kernel.shape[-1]) * decim,
                -(-(pad_l + n) // decim) * decim)
    xv = kc._x2_view(x, pad_l, total, decim).to(dtype).contiguous()
    kd = kernel.to(dtype)
    return lambda: F.conv1d(xv, kd, stride=fold)


def phase_timing(device, card: str) -> dict:
    import torch
    from tetraear_tpu_torch.models.multicarrier import (
        MulticarrierFrontend, PfbMulticarrierFrontend)
    from tetraear_tpu_torch.ops import fused
    from tetraear_tpu_torch.ops.channelizer import carrier_grid
    from tetraear_tpu_torch.ops.kernels import s2d_conv as kc
    x, k2, gc, L, decim = _case(16, BENCH_N, 2, device)
    tc = kc.tc_pack_k1(k2)       # the tensor-core route's weights, as a
    t = {}                       # frontend packs them once

    def report(name, key, kernel_fn, plain_fn, plain_name, work, peak,
               library_fn=None, iters=10):
        ms, plain_ms, runs = _pair_ms(kernel_fn, plain_fn, iters)
        bound_ms, by = _bound(*work, peak)
        lib_ms = None
        if library_fn is not None:
            lib_ms = (_time_ms(library_fn, iters)
                      + _time_ms(library_fn, iters)) / 2
        t[key] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                  "bound_by": by, "library_ms": lib_ms}
        lib = ("" if lib_ms is None else
               f"; cuDNN F.conv1d ({'bf16 operands and output' if peak == PEAK_BF16 else 'f32, TF32 off'}) {lib_ms:.4f} ms")
        print(f"[timing] {card}: {name} {runs[0]:.4f} / {runs[1]:.4f} ms "
              f"= {work[0] / ms / 1e9:.1f} TFLOP/s, bound {bound_ms:.4f} ms "
              f"({by}; {work[0] / 1e9:.1f} GFLOP, {work[1] / 1e6:.1f} MB) "
              f"= {bound_ms / ms:.1%} of it; {plain_name} {runs[2]:.4f} / "
              f"{runs[3]:.4f} ms{lib}")

    for bf16 in (True, False):
        tag = "bf16" if bf16 else "f32"
        report(f"K1 {tag}{' (tensor cores)' if bf16 else ''}", f"k1_{tag}",
               lambda: kc.s2d_conv(x, k2, gc, L, decim, bf16=bf16, tc=tc),
               lambda: kc.s2d_conv_plain(x, k2, gc, L, decim, bf16=bf16),
               "plain F.conv1d", _conv_work(x, k2, 1, decim),
               PEAK_BF16 if bf16 else PEAK_F32,
               _library_conv(x, k2, gc, L, decim, 1,
                             torch.bfloat16 if bf16 else torch.float32))
    report("K3 f32", "k3",
           lambda: kc.s2d_conv_db(x, k2, gc, L, decim),
           lambda: kc.s2d_conv_plain(x, k2, gc, L, decim), "plain F.conv1d",
           _conv_work(x, k2, 1, decim), PEAK_F32,
           _library_conv(x, k2, gc, L, decim, 1, torch.float32))
    report("K3 f32", "k3_vs_k1",
           lambda: kc.s2d_conv_db(x, k2, gc, L, decim),
           lambda: kc.s2d_conv(x, k2, gc, L, decim), "K1 f32",
           _conv_work(x, k2, 1, decim), PEAK_F32)
    k_of = torch.as_tensor(fused.fold_s2d_kernel(k2.cpu().numpy(), 4),
                           device=device)
    tc_of = kc.tc_pack(k_of, 4)
    for bf16 in (True, False):
        tag = "bf16" if bf16 else "f32"
        report(f"K1-of fold 4 {tag}{' (tensor cores)' if bf16 else ''}",
               f"k1of_{tag}",
               lambda: kc.s2d_conv_of(x, k_of, gc, L, decim, 4, bf16=bf16,
                                      tc=tc_of),
               lambda: kc.s2d_conv_of_plain(x, k_of, gc, L, decim, 4,
                                            bf16=bf16),
               "plain stride-4 F.conv1d + un-fold",
               _conv_work(x, k_of, 4, decim),
               PEAK_BF16 if bf16 else PEAK_F32,
               _library_conv(x, k_of, gc, L, decim, 4,
                             torch.bfloat16 if bf16 else torch.float32))
    report("K1-of fold 4 bf16", "k1of_vs_k1",
           lambda: kc.s2d_conv_of(x, k_of, gc, L, decim, 4, bf16=True,
                                  tc=tc_of),
           lambda: kc.s2d_conv(x, k2, gc, L, decim, bf16=True, tc=tc),
           "K1 bf16",
           _conv_work(x, k_of, 4, decim), PEAK_BF16)

    # another rate: 16 carriers at 8 MS/s (2D = 66, K = 5082), where the
    # weights stream through shared memory and the A loads are 4 bytes
    x8, k8, gc8, L8, d8 = _case(16, BENCH_N, 2, device, 8.0)
    tc8 = kc.tc_pack_k1(k8)
    report(f"K1 bf16 (tensor cores) at 8 MS/s, 16 carriers (2D = 66, "
           f"{tc8.kchunk} of {tc8.packed.shape[1]} k-steps of weights "
           "resident)", "k1_bf16_8msps",
           lambda: kc.s2d_conv(x8, k8, gc8, L8, d8, bf16=True, tc=tc8),
           lambda: kc.s2d_conv_plain(x8, k8, gc8, L8, d8, bf16=True),
           "plain F.conv1d", _conv_work(x8, k8, 1, d8), PEAK_BF16,
           _library_conv(x8, k8, gc8, L8, d8, 1, torch.bfloat16), iters=6)
    del x8, k8, tc8

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
        work = _conv_work(x, kp, 1, decim)
        if conv == "pallas_bf16":
            report("full band (C2=192, gc=0): K1 bf16 (tensor cores)",
                   "pfb_k1_bf16",
                   lambda: kc.s2d_conv(x, kp, 0, lp, decim, bf16=True,
                                       tc=pfb.tc),
                   lambda: kc.s2d_conv_plain(x, kp, 0, lp, decim, bf16=True),
                   "plain F.conv1d", work, PEAK_BF16,
                   _library_conv(x, kp, 0, lp, decim, 1, torch.bfloat16),
                   iters=6)
        else:
            report("full band (C2=192, gc=0): K3 f32", "pfb_k3",
                   lambda: kc.s2d_conv_db(x, kp, 0, lp, decim),
                   lambda: kc.s2d_conv_plain(x, kp, 0, lp, decim),
                   "plain F.conv1d", work, PEAK_F32,
                   _library_conv(x, kp, 0, lp, decim, 1, torch.float32),
                   iters=6)
            report("full band (C2=192, gc=0): K3 f32", "pfb_k3_vs_k1",
                   lambda: kc.s2d_conv_db(x, kp, 0, lp, decim),
                   lambda: kc.s2d_conv(x, kp, 0, lp, decim),
                   "K1 f32", work, PEAK_F32, iters=6)
        t[f"pfb_{conv}"] = _frontend_timing(
            f"full-band frontend {conv}, 96 channels", pfb, x, card,
            iters=6)
        del pfb, x
        torch.cuda.empty_cache()
    phase_timing_k4(device, card, t)
    phase_timing_staged(device, card, t)
    return t


def phase_timing_k4(device, card: str, t: dict) -> None:
    """K4 against its plain version and against K1 at C2 = 32: dt on the
    CUDA cores, dt_bf16 on the tensor cores (packed once, as a caller
    holding the weights would), each with its bound and the cuDNN conv of
    the same contraction in its type."""
    import torch
    from tetraear_tpu_torch.ops.kernels import s2d_conv as kc
    x, k2, gc, L, decim = _case(16, BENCH_N, 2, device)
    tc = kc.tc_pack_k1(k2)
    tc_dt = kc.tc_pack_dt(k2)
    for bf16 in (False, True):
        tag = "bf16" if bf16 else "f32"
        for key, other, name in (
                ("plain", lambda: kc.s2d_conv_plain(x, k2, gc, L, decim,
                                                    bf16=bf16),
                 "plain F.conv1d"),
                ("k1", lambda: kc.s2d_conv(x, k2, gc, L, decim, bf16=bf16,
                                           tc=tc),
                 f"K1 {tag}")):
            ms, other_ms, runs = _pair_ms(
                lambda: kc.s2d_conv_dt(x, k2, gc, L, decim, bf16=bf16,
                                       tc=tc_dt),
                other, 10)
            t.setdefault(f"k4_{tag}", {"ms": ms})
            t[f"k4_{tag}"][f"{key}_ms"] = other_ms
            print(f"[timing] {card}: K4 {'dt_bf16' if bf16 else 'dt'} "
                  f"{runs[0]:.4f} / {runs[1]:.4f} ms, {name} {runs[2]:.4f} / "
                  f"{runs[3]:.4f} ms")
        # K4 computes K1's function: K1's bound in the same type, and the
        # same library call timed here on K4's inputs
        k4 = t[f"k4_{tag}"]
        work = _conv_work(x, k2, 1, decim)
        k4["bound_ms"], k4["bound_by"] = _bound(
            *work, PEAK_BF16 if bf16 else PEAK_F32)
        lib = _library_conv(x, k2, gc, L, decim, 1,
                            torch.bfloat16 if bf16 else torch.float32)
        k4["library_ms"] = (_time_ms(lib) + _time_ms(lib)) / 2
        print(f"[timing] {card}: K4 {'dt_bf16' if bf16 else 'dt'} "
              f"{k4['ms']:.4f} ms = {work[0] / k4['ms'] / 1e9:.1f} TFLOP/s, "
              f"bound {k4['bound_ms']:.4f} ms ({k4['bound_by']}) = "
              f"{k4['bound_ms'] / k4['ms']:.1%} of it; cuDNN F.conv1d "
              f"({'bf16 operands and output' if bf16 else 'f32, TF32 off'}) "
              f"{k4['library_ms']:.4f} ms")


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
        GatherPfbFrontend, StagedMulticarrierFrontend)
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
    # per input sample and carrier one complex rotation (6 FLOP; the
    # oscillator is not counted), per output and tap one complex-by-real
    # multiply-add (4 FLOP); x read once, the complex64 output written once
    carriers, taps = mc.offsets_hz.shape[0], mc.taps_d.shape[0]
    m_out = -(-BENCH_N // mc.decim)
    bound_ms, by = _bound(
        6.0 * carriers * BENCH_N + 4.0 * carriers * m_out * taps,
        8.0 * BENCH_N + 8.0 * carriers * m_out, PEAK_F32)
    # the oscillators' floor: K5_OSC_INSTRUCTIONS issued per carrier and
    # sample at one instruction per lane, 4 schedulers x 32 lanes a clock
    # on every SM, at the card's maximum SM clock
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    mhz = _max_sm_mhz()
    osc_ms = (K5_OSC_INSTRUCTIONS * carriers * BENCH_N
              / (sms * 4 * 32 * mhz * 1e6) * 1e3)
    t["k5"] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
               "bound_by": by, "library_ms": None, "osc_floor_ms": osc_ms}
    print(f"[timing] {card}: K5 {ms:.4f} ms; FLOP bound {bound_ms:.4f} ms "
          f"({by}) = {bound_ms / ms:.1%} of it; oscillator floor "
          f"{osc_ms:.4f} ms ({K5_OSC_INSTRUCTIONS} instructions x "
          f"{carriers} x {BENCH_N} oscillators on {sms} SMs x 128 lanes at "
          f"{mhz:.0f} MHz) = {osc_ms / ms:.1%} of it")
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
    # the same launch with every |phase| under 2.2e4 rad (16 carriers at
    # 1 kHz): the exact reduction makes the time independent of the phase
    low = torch.full_like(mc.offsets_hz, 1e3)
    fast_ms = _time_ms(lambda: k5.fused_channelize(x, low, *args[1:]))
    print(f"[timing] {card}: K5 with every |phase| under 2.2e4 rad "
          f"{fast_ms:.3f} ms (the bench carriers' {ms:.3f} ms)")
    t["k5"]["small_phase_ms"] = fast_ms
    # the generic path: the staged frontend's taps at 8 MS/s on the same
    # samples (L = 397, D = 33)
    from tetraear_tpu_torch.config import ReceiverConfig
    from tetraear_tpu_torch.models.realpair import staged_state
    st8 = staged_state(carrier_grid(16), ReceiverConfig(sample_rate_hz=8e6))
    args8 = (torch.as_tensor(st8.offsets_hz, device=device),
             st8.sample_rate_hz, st8.decim,
             torch.as_tensor(st8.taps_d, device=device))
    ms8, plain8, runs8 = _pair_ms(lambda: k5.fused_channelize(x, *args8),
                                  lambda: k5.fused_channelize_plain(x, *args8),
                                  iters=4)
    print(f"[timing] {card}: K5 generic path (8 MS/s taps: L = "
          f"{len(st8.taps_d)}, D = {st8.decim}, "
          f"{k5.tile_outputs(len(st8.taps_d), st8.decim)} outputs a tile) "
          f"{runs8[0]:.3f} / {runs8[1]:.3f} ms, plain {runs8[2]:.3f} / "
          f"{runs8[3]:.3f} ms")
    y = k5.fused_channelize(x, *args)
    yc = fir_filter_same(y, mc.taps_c)
    bits, corr, count = mc.demod(yc)
    stages = {"channel FIR": lambda: fir_filter_same(y, mc.taps_c),
              "demod front": lambda: mc.demod(yc),
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
# The ETSI downlink, the cell survey and the uplink monitors
# ---------------------------------------------------------------------------

DL_SLOTS = 72                # one multiframe: 18 frames x 4 slots, ~1.02 s
DL_MESSAGE = "CHIP SDS"
CELLS = (3, 8, 12)           # grid indices of carrier_grid(16) with a cell


def _quiet_cli(argv: list) -> tuple:
    """(exit code, stdout) of the port's CLI on argv."""
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = _cli(argv)
    return rc, buf.getvalue()


def _cli_out(argv: list) -> tuple:
    """The port's CLI on argv with -o into a temporary file: (exit code,
    its stdout lines, the JSONL rows)."""
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "out.jsonl"
        rc, stdout = _quiet_cli([*argv, "-o", str(out)])
        rows = ([json.loads(line) for line in out.read_text().splitlines()]
                if out.exists() else [])
    return rc, stdout.splitlines(), rows


def _dl_check(tag: str, cond: bool, msg: str) -> None:
    print(f"[downlink] {tag}: {msg}: {'ok' if cond else 'FAIL'}")
    if not cond:
        fail("downlink", f"{tag}: {msg}")


def _downlink_cli_run() -> None:
    """`downlink --simulate --slots 72` on the card and, as the plain
    version, the same command with --device cpu: every planted SDS text,
    the SDS-TL text, the group call's CMCE PDUs and the cell identity
    decoded, and every row (CRC verdicts included) equal."""
    argv = ["downlink", "--simulate", "--slots", str(DL_SLOTS),
            "--message", DL_MESSAGE]
    rc, lines, rows = _cli_out(argv)
    rc_cpu, _, rows_cpu = _cli_out([*argv, "--device", "cpu"])
    tag = f"cli downlink --simulate --slots {DL_SLOTS}"
    print(f"[downlink] {tag}: exit {rc} (cpu {rc_cpu}), {len(rows)} slots, "
          f"{sum(r['crc_ok'] is True for r in rows)} CRC-pass; "
          + "; ".join(line for line in lines
                      if line.startswith(("[VOICE]", "[DONE]", "[SIM]"))))
    _dl_check(tag, rc == 0 == rc_cpu, "both runs exit 0")
    sds = {r["sds"] for r in rows}
    want = [f"[TXT] {DL_MESSAGE} #{k}" for k in range(1, DL_SLOTS - 1, 4)]
    missing = [w for w in want if w not in sds]
    _dl_check(tag, not missing, f"{len(want)} planted SCH/F texts decoded"
              + (f" (missing {missing})" if missing else ""))
    layer3 = " | ".join(" ; ".join(r["layer3"] or []) for r in rows)
    for pdu in ("DSetup: call 41", "DTxGranted: call 41",
                f"text '{DL_MESSAGE} via SDS-TL'", "DRelease: call 41"):
        _dl_check(tag, pdu in layer3, f"layer 3 {pdu!r} decoded")
    _dl_check(tag, any(r["mcc"] == 262 and r["mnc"] == 1001 for r in rows),
              "cell MCC 262 MNC 1001 acquired")
    _dl_check(tag, {r["fn"] for r in rows} == set(range(1, 19)),
              "all 18 frames of the multiframe, frame 18 included")
    _dl_check(tag, rows == rows_cpu,
              "rows (CRC verdicts, AACH, layer 3, calls) equal the "
              "--device cpu run's")


def _survey_plain(x, device) -> list:
    """MulticarrierDownlinkReceiver's decode with K5's plain version
    (mix_to_baseband + fir_decimate) on the card in its place: per
    carrier, the decoded frames."""
    import torch
    from tetraear_tpu_torch.models.downlink import (
        MulticarrierDownlinkReceiver)
    from tetraear_tpu_torch.ops import dqpsk, resample, timing
    from tetraear_tpu_torch.ops.kernels.fused_channelize import (
        fused_channelize_plain)
    rx = MulticarrierDownlinkReceiver(16, device=device)
    cfg = rx.cfg
    chans = fused_channelize_plain(torch.as_tensor(x, device=device),
                                   rx._offsets_dev, cfg.sample_rate_hz,
                                   cfg.decimation_factor, rx._taps_d)
    z = resample.rational_resample(chans, 3, 10, rx._taps_r)
    ts = timing.best_phase_pick(z, cfg.etsi_sps, step=1)
    soft = dqpsk.demodulate_soft(ts.symbols).soft_bits.cpu().numpy()
    counts = ts.count.cpu().numpy()
    return [rx._cells[c].receive_soft(soft[c, :counts[c] - 1].reshape(-1))
            if counts[c] >= 2 else [] for c in range(16)]


def _frame_decisions(frames) -> list:
    return [(f.slot_index, f.tn, f.fn, f.mn, f.channel, f.crc_ok,
             f.aach.downlink_usage, f.sds_message) for f in frames]


def _survey_run(device) -> None:
    """`downlink FILE --survey 16` on three cells planted on carriers
    CELLS of carrier_grid(16), one multiframe long: each cell's identity
    reported on its carrier and no other cell; then
    MulticarrierDownlinkReceiver on the same capture (K5): each cell's
    text, and every carrier's decisions equal those made from K5's
    plain version."""
    import numpy as np
    from tetraear_tpu_torch.models.downlink import (
        MulticarrierDownlinkReceiver)
    from tetraear_tpu_torch.utils.synth import planted_cells
    x, want = planted_cells(CELLS, slots=DL_SLOTS)
    tag = f"cli downlink --survey 16 ({len(x)} samples)"
    with tempfile.TemporaryDirectory() as tmp:
        iq = Path(tmp) / "cells.cf32"
        np.asarray(x, np.complex64).tofile(iq)
        rc, lines, _ = _cli_out(["downlink", str(iq), "--survey", "16"])
    cells = [line for line in lines if line.startswith("carrier")]
    for line in cells + [ln for ln in lines if ln.startswith("[DONE]")]:
        print(f"[downlink]   {line}")
    _dl_check(tag, rc == 0 and len(cells) == len(want),
              f"exit 0, {len(want)} cells reported")
    for k, (mcc, mnc, cc_, _) in want.items():
        hit = any(line.startswith(f"carrier {k:3d}")
                  and f"MCC={mcc} MNC={mnc} CC={cc_}" in line
                  and "crc=100%" in line for line in cells)
        _dl_check(tag, hit, f"carrier {k}: MCC={mcc} MNC={mnc} CC={cc_}, "
                            "every CRC passed")
    per = MulticarrierDownlinkReceiver(16, device=device).receive(x)
    plain = _survey_plain(x, device)
    tag = "MulticarrierDownlinkReceiver(16) (K5)"
    for k, (_, _, _, text) in want.items():
        _dl_check(tag, text in {f.sds_message for f in per[k]},
                  f"carrier {k}: {text!r} decoded")
    same = all(_frame_decisions(a) == _frame_decisions(b)
               for a, b in zip(per, plain))
    _dl_check(tag, same, "every carrier's slots, CRC verdicts, AACH and "
                         "texts equal those from K5's plain version")


def _uplink_cli_run() -> None:
    """`uplink --simulate` with and without --continuous on the card and
    with --device cpu: every burst's CMCE / SDS decoded, rows equal."""
    for extra in ([], ["--continuous"]):
        argv = ["uplink", "--simulate", *extra]
        rc, lines, rows = _cli_out(argv)
        rc_cpu, _, rows_cpu = _cli_out([*argv, "--device", "cpu"])
        tag = "cli " + " ".join(argv)
        print(f"[downlink] {tag}: exit {rc} (cpu {rc_cpu}), {len(rows)} "
              "bursts; " + "; ".join(
                  line for line in lines
                  if line.startswith(("bit", "[VOICE]", "[SIM]"))))
        _dl_check(tag, rc == 0 == rc_cpu, "both runs exit 0")
        text = " | ".join(" ; ".join(r["layer3"] or []) + f" {r['sds']}"
                          for r in rows)
        for item in ("LEGACY UPLINK SDS", "USdsData: called SSI 42",
                     "USetup: called SSI 9000", "uplink report 7"):
            _dl_check(tag, item in text, f"{item!r} decoded")
        _dl_check(tag, rows == rows_cpu,
                  "rows (CRC verdicts, layer 3) equal the --device cpu run's")


def phase_downlink(device) -> dict:
    """The ETSI downlink, the 16-carrier survey (K5) and both uplink
    monitors through the CLI, each with the launch counts set to 0 just
    before and read just after; the survey must launch K5, the downlink
    and the uplink the Viterbi."""
    launches = dict.fromkeys(KERNELS, 0)
    for tag, wrapper, run in (
            ("cli downlink --simulate (one multiframe)", "viterbi",
             _downlink_cli_run),
            ("cli downlink --survey 16 + MulticarrierDownlinkReceiver",
             "fused_channelize", lambda: _survey_run(device)),
            ("cli uplink --simulate [--continuous]", "viterbi",
             _uplink_cli_run)):
        for name, n in _path(tag, wrapper, run).items():
            launches[name] += n
    return launches


def phase_timing_downlink(device, card: str) -> None:
    """Per capture: DownlinkReceiver.receive on the one-multiframe
    capture and its parts (the etsi demodulator, the batched slot decode,
    one SCH/F group's channel decode), the survey at 2.45 M and at the
    bench's 8,319,936 samples, and the uplink monitors, each with its
    device busy share (host clock around a synchronized call)."""
    import numpy as np
    import torch
    from tetraear_tpu_torch.models.downlink import (
        DownlinkConfig, DownlinkReceiver, DownlinkTransmitter,
        MulticarrierDownlinkReceiver, survey_cells)
    from tetraear_tpu_torch.models.uplink import (UplinkMonitor,
                                                  UplinkSlotMonitor,
                                                  UplinkTransmitter)
    from tetraear_tpu_torch.ops import channel_coding as cc
    from tetraear_tpu_torch.utils.synth import (make_mac_block_bits,
                                                planted_cells)

    def host_ms(fn, iters: int = 3) -> float:
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / iters * 1e3

    def report(tag: str, fn, n: int, iters: int = 3) -> float:
        ms = host_ms(fn, iters)
        busy_ms, top = _device_busy_ms(fn, iters=1)
        busy = ("not measured" if busy_ms is None else
                f"{busy_ms:.3f} ms ({busy_ms / ms:.1%}); top "
                + ", ".join(f"{k[:36]} {v:.3f}" for k, v in top[:3]))
        print(f"[timing] {card}: {tag} (n={n}) {ms:.3f} ms per capture = "
              f"{n / (ms / 1e3):,.0f} samples/s; device busy {busy}")
        return ms

    tx = DownlinkTransmitter(DownlinkConfig())
    pay = {k: make_mac_block_bits(b"TIMING %d" % k, seed=k)
           for k in range(1, DL_SLOTS, 4)}
    iq = tx.modulate(tx.stream_bits(DL_SLOTS, payloads=pay), snr_db=25.0,
                     seed=1)
    rx = DownlinkReceiver(device=device)
    report(f"DownlinkReceiver.receive, {DL_SLOTS} slots", lambda:
           rx.receive(iq), len(iq))
    x = torch.as_tensor(iq, device=device)
    res = rx.rx(x, 0.0)
    soft = res.soft_bits[:int(res.count) - 1].reshape(-1).cpu().numpy()
    report("  its etsi demodulator (EtsiReceiver)", lambda: rx.rx(x, 0.0),
           len(iq), 5)
    report("  its host walk + batched slot decode (receive_soft)",
           lambda: rx.receive_soft(soft), len(iq))
    for blocks in (18, 36):
        llrs = torch.as_tensor(np.random.default_rng(0).standard_normal(
            (blocks, 432)).astype(np.float32), device=device)
        ms = host_ms(lambda: cc.decode_channel_soft(llrs, "SCH/F", 17), 3)
        print(f"[timing] {card}:   one SCH/F group's channel decode "
              f"({blocks} blocks, Viterbi over 288 steps) {ms:.3f} ms")
    xs, _ = planted_cells(CELLS, slots=DL_SLOTS)
    report("survey_cells, 16 carriers (K5)", lambda: survey_cells(
        xs, 16, device=device), len(xs))
    mc = MulticarrierDownlinkReceiver(16, device=device)
    xd = torch.as_tensor(xs, device=device)
    report("  its device front (K5 + etsi tail, 16 carriers)",
           lambda: mc.demodulate(xd), len(xs), 5)
    reps = -(-BENCH_N // len(xs))
    xb = np.tile(xs, reps)[:BENCH_N]
    report("survey_cells, 16 carriers (K5), bench block", lambda:
           survey_cells(xb, 16, device=device), BENCH_N, 2)
    xbd = torch.as_tensor(xb, device=device)
    report("  its device front (K5 + etsi tail), bench block",
           lambda: mc.demodulate(xbd), BENCH_N, 3)
    del xd, xbd
    ecc = (262 << 20) | (1001 << 6) | 17
    utx = UplinkTransmitter(ecc)
    bursts = [utx.nub_bits(make_mac_block_bits(b"UL %d" % k, seed=k))
              for k in range(8)]
    iq_ul = utx.transmit(bursts, snr_db=22.0, seed=2)
    report("UplinkMonitor.receive, 8 bursts", lambda: UplinkMonitor(
        ecc, device=device).receive(iq_ul), len(iq_ul))
    iq_sl = utx.transmit_slots({2 * k + 1: b for k, b in enumerate(bursts)},
                               18, lead_bits=120, snr_db=22.0, seed=2)
    report("UplinkSlotMonitor.receive, 18 slots", lambda: UplinkSlotMonitor(
        ecc, device=device).receive(iq_sl), len(iq_sl))
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# The operator's commands: the receive loop, the scanner, the waterfall, the
# terminal UI
# ---------------------------------------------------------------------------

LISTEN_FRAMES = 20           # planted slots of the listen capture: 5 chunks
LISTEN_CHUNKS = 4            # --max-chunks of the listen and tui runs
CHUNK = 128 * 1024           # CaptureLoop's chunk (capture_loop.py:38)
SCAN_CENTER_MHZ = 392.5
SCAN_OFFSETS = (-300e3, 0.0, 475e3)      # planted_scan's channels
SCAN_USABLE = ((1 << 20) // 5120) * 5120  # the sweep's validated samples
DB_TOL = 1e-3                # dB, waterfall bins within 60 dB of the peak
# and on every bin |amplitude - the cpu's| within TOL x the row's peak
# amplitude: two f32 FFTs differ by an absolute rounding error, which in
# dB grows without bound as a bin's power falls (a noise null 100 dB
# under the peak read 0.065 dB apart on the card, 6.6e-7 x the peak)


def scan_channels_hz():
    """Offsets of every channel one 2.4 MS/s sweep covers (scanner.py: the
    25 kHz grid within fs / 2 - 25 kHz of the centre): 95 of them."""
    import numpy as np
    fs, step, c = 2.4e6, 25e3, SCAN_CENTER_MHZ * 1e6
    half = fs / 2 - step
    first, last = int(np.ceil((c - half) / step)), int((c + half) // step)
    return np.arange(first, last + 1) * step - c


def _op_check(tag: str, cond: bool, msg: str) -> None:
    print(f"[operator] {tag}: {msg}: {'ok' if cond else 'FAIL'}")
    if not cond:
        fail("operator", f"{tag}: {msg}")


def _captures(tmp: Path) -> tuple:
    """The listen capture (LISTEN_FRAMES golden slots, "[TXT] HELLO
    HELLO") and the scan capture (planted_scan: three texts on 25 kHz
    channels over noise, one sweep long) as .cf32 files in tmp."""
    import numpy as np
    from tetraear_tpu_torch.utils.synth import planted_scan, planted_single
    x1, text = planted_single("ref-compat", num_frames=LISTEN_FRAMES)
    xs, want = planted_scan(SCAN_OFFSETS)
    listen, scan = tmp / "listen.cf32", tmp / "scan.cf32"
    np.asarray(x1, np.complex64).tofile(listen)
    np.asarray(xs, np.complex64).tofile(scan)
    return listen, text, scan, want


def _listen_run(listen: Path, text: str, tmp: Path) -> int:
    """`listen --iq-file f --no-afc --max-chunks 4 -o out.jsonl
    --no-auto-decrypt` on the card and with --device cpu: the planted text
    in every frame, frames from at least 3 chunks, the JSONL bytes equal;
    returns the frames decoded."""
    argv = ["listen", "--iq-file", str(listen), "--no-afc", "--max-chunks",
            str(LISTEN_CHUNKS), "--no-auto-decrypt"]
    out, out_cpu = tmp / "listen.jsonl", tmp / "listen_cpu.jsonl"
    rc, stdout = _quiet_cli([*argv, "-o", str(out)])
    rc_cpu, _ = _quiet_cli([*argv, "--device", "cpu", "-o", str(out_cpu)])
    rows = [json.loads(line) for line in out.read_text().splitlines()]
    # a chunk's frames are numbered from its start: a new chunk restarts
    numbers = [r["number"] for r in rows]
    chunks = 1 + sum(b <= a for a, b in zip(numbers, numbers[1:]))
    tag = f"cli listen --max-chunks {LISTEN_CHUNKS} ({LISTEN_FRAMES} slots)"
    print(f"[operator] {tag}: exit {rc} (cpu {rc_cpu}), {len(rows)} frames "
          f"from at least {chunks} chunks; " + "; ".join(
              line for line in stdout.splitlines()
              if line.startswith(("Decoded", "Frames:", "[DEVICE]"))))
    _op_check(tag, rc == 0 == rc_cpu, "both runs exit 0")
    _op_check(tag, bool(rows) and {r.get("sds_message") for r in rows}
              == {text}, f"every frame carries {text!r}")
    _op_check(tag, chunks >= 3, "frames decoded from at least 3 chunks")
    _op_check(tag, out.read_bytes() == out_cpu.read_bytes(),
              "JSONL equal, byte for byte, to the --device cpu run's")
    return len(rows)


def _listen_synthetic_run(tmp: Path) -> None:
    wf = tmp / "wf.ppm"
    rc, _ = _quiet_cli(["listen", "--synthetic", "-f", "392.5",
                             "--max-chunks", "4", "--no-auto-decrypt",
                             "--waterfall", str(wf)])
    tag = "cli listen --synthetic --max-chunks 4 --waterfall"
    _op_check(tag, rc == 0 and wf.exists()
              and wf.read_bytes().startswith(b"P6\n2048 4\n255\n"),
              "exit 0, a 2048 x 4 PPM written")


def _scan_decisions(result: list) -> list:
    return [(r["frequency"], r["is_tetra"], r.get("frames_validated"),
             r.get("crc_pass_rate"), r.get("sync_detected"),
             r["signal_present"]) for r in result]


class _FixedSource:
    """One capture read again at every call, for the scanner's sweep."""

    def __init__(self, x):
        self.x = x

    def set_frequency(self, frequency: float) -> None:
        pass

    def read_samples(self, num_samples: int):
        return self.x[:num_samples]


def _scan_wideband_run(scan: Path, want: dict, device) -> None:
    """`scan 391.4 393.6 --iq-file f -f 392.5 --wideband` on the card
    (K5 validates the hot channels): each planted channel tagged TETRA in
    the printed top 20, no other; then scan_wideband on the card and on
    the CPU: every channel's decisions equal, powers within DB_TOL."""
    import numpy as np
    from tetraear_tpu_torch.signal.scanner import FrequencyScanner
    argv = ["scan", "391.4", "393.6", "--iq-file", str(scan), "-f",
            str(SCAN_CENTER_MHZ), "--wideband"]
    rc, stdout = _quiet_cli(argv)
    lines = [ln for ln in stdout.splitlines()
             if re.match(r"\s+\d+\.\d{3} MHz: ", ln)]
    tagged = sorted(float(ln.split()[0]) for ln in lines
                    if ln.endswith("*** TETRA"))
    planted = sorted(round(SCAN_CENTER_MHZ + off / 1e6, 3) for off in want)
    tag = "cli scan --wideband"
    print(f"[operator] {tag}: exit {rc}; top: " + "; ".join(
        ln.strip() for ln in lines[:6]))
    _op_check(tag, rc == 0 and len(lines) == 20, "exit 0, the top 20 "
                                                 "channels printed")
    _op_check(tag, tagged == planted,
              f"the planted channels {planted} MHz, and only they, TETRA")
    x = np.fromfile(scan, np.complex64)
    res = {}
    for dev in (device, "cpu"):
        sc = FrequencyScanner(_FixedSource(x), settle_s=0.0, device=dev)
        res[str(dev)] = sc.scan_wideband(SCAN_CENTER_MHZ * 1e6)
    got, cpu = res[str(device)], res["cpu"]
    hot = [r for r in got if r["power_db"] > -70]
    db = max(abs(a["power_db"] - b["power_db"]) for a, b in zip(got, cpu))
    print(f"[operator] scan_wideband: {len(got)} channels, {len(hot)} hot "
          f"(K5 at C = {len(hot)}), max |power - cpu's| = {db:.2e} dB")
    _op_check("scan_wideband", _scan_decisions(got) == _scan_decisions(cpu),
              "every channel's is_tetra, frames_validated, crc_pass_rate, "
              "sync_detected and signal_present equal the --device cpu "
              "run's")
    _op_check("scan_wideband", db <= DB_TOL, f"powers within {DB_TOL} dB")


def _scan_stepped_run(scan: Path) -> None:
    """The stepped scan over 5 channels around the capture's centre on the
    card and with --device cpu: the same result lines."""
    argv = ["scan", "392.45", "392.55", "--iq-file", str(scan), "-f",
            str(SCAN_CENTER_MHZ)]
    rc, stdout = _quiet_cli(argv)
    rc_cpu, stdout_cpu = _quiet_cli([*argv, "--device", "cpu"])

    def results(text):
        return [ln for ln in text.splitlines()
                if re.match(r"\s+\d+\.\d{3} MHz: ", ln)
                or ln.startswith(("[OK]", "[X]"))]
    tag = "cli scan 392.45 392.55 (stepped, 5 channels)"
    print(f"[operator] {tag}: exit {rc} (cpu {rc_cpu}); " + "; ".join(
        ln.strip() for ln in results(stdout)))
    _op_check(tag, rc == 0 == rc_cpu and len(results(stdout)) == 6,
              "both runs exit 0, 5 channels and the best signal printed")
    _op_check(tag, results(stdout) == results(stdout_cpu),
              "the result lines equal the --device cpu run's")


def _waterfall_run(scan: Path, tmp: Path, device) -> None:
    """`waterfall f -o wf.png` on the card; its power rows (200 of 2048
    points) against the --device cpu rows."""
    import numpy as np
    from tetraear_tpu_torch.ui.cli import waterfall_power
    out = tmp / "wf.png"
    rc, stdout = _quiet_cli(["waterfall", str(scan), "-o", str(out)])
    tag = "cli waterfall"
    _op_check(tag, rc == 0 and out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
              and "[OK] 2048x200 waterfall" in stdout,
              "exit 0, a 2048 x 200 PNG written")
    x = np.fromfile(scan, np.complex64)
    got = waterfall_power(x, 2048, 200, device).astype(np.float64)
    want = waterfall_power(x, 2048, 200, "cpu").astype(np.float64)
    live = want > want.max() - 60.0
    err, err_all = (np.abs(got - want)[live].max(),
                    np.abs(got - want).max())
    amp, amp_cpu = 10 ** (got / 20), 10 ** (want / 20)
    amp_err = (np.abs(amp - amp_cpu).max(axis=1)
               / amp_cpu.max(axis=1)).max()
    print(f"[operator] waterfall rows {got.shape}: max |card - cpu| "
          f"{err:.2e} dB on bins within 60 dB of the peak "
          f"({live.mean():.1%} of them), {err_all:.2e} dB on every bin; "
          f"max |amplitude - cpu's| {amp_err:.2e} x the row's peak")
    _op_check(tag, got.shape == want.shape and err <= DB_TOL
              and amp_err <= TOL,
              f"rows within {DB_TOL} dB of the --device cpu rows on bins "
              f"within 60 dB of the peak, every bin's amplitude within "
              f"{TOL} x its row's peak")


def _tui_run(listen: Path, frames: int) -> None:
    """`tui --iq-file f --max-chunks 4 --duration 5` without a terminal:
    exit 0, and its session summary counts the frames `listen` decoded
    from the same chunks."""
    rc, stdout = _quiet_cli(["tui", "--iq-file", str(listen), "--no-afc",
                             "--max-chunks", str(LISTEN_CHUNKS),
                             "--duration", "5", "--no-auto-decrypt"])
    summary = stdout[stdout.rfind("Frames: "):].splitlines()
    tag = "cli tui (headless)"
    print(f"[operator] {tag}: exit {rc}; " + " | ".join(summary[:2]))
    _op_check(tag, rc == 0 and bool(summary)
              and summary[0].startswith(f"Frames: {frames} "),
              f"exit 0, the session summary counts the {frames} frames")


def _fault_run(listen: Path) -> None:
    """A listen whose processor fails on the card (it asks the allocator
    for 2^50 bytes: a CUDA-side RuntimeError) must end with the error."""
    import torch
    from tetraear_tpu_torch.models.receiver import SignalProcessor
    saved = SignalProcessor.process

    def failing(self, samples, freq_offset=0.0):
        torch.empty(1 << 50, dtype=torch.uint8, device=self.device)
        return saved(self, samples, freq_offset)
    SignalProcessor.process = failing
    try:
        rc, _ = _quiet_cli(["listen", "--iq-file", str(listen), "--no-afc",
                            "--max-chunks", "2"])
        raised = None
    except RuntimeError as e:
        rc, raised = None, e
    finally:
        SignalProcessor.process = saved
    torch.cuda.empty_cache()
    print(f"[operator] cli listen with a failing device: "
          + (f"raised {type(raised).__name__}: {str(raised)[:80]}"
             if raised is not None else f"exit {rc}"))
    _op_check("device fault", raised is not None,
              "the command ends with the CUDA error (a nonzero exit)")


def phase_operator(device) -> dict:
    """4c: the operator's commands through the CLI, each path with the
    launch counts set to 0 just before and read just after; the wideband
    scan must launch K5."""
    launches = dict.fromkeys(KERNELS, 0)
    with tempfile.TemporaryDirectory() as tmp_name:
        tmp = Path(tmp_name)
        listen, text, scan, want = _captures(tmp)
        frames = {}
        runs = (
            ("cli listen (replay, -o) against --device cpu", None,
             lambda: frames.setdefault("n", _listen_run(listen, text, tmp))),
            ("cli listen --synthetic --waterfall", None,
             lambda: _listen_synthetic_run(tmp)),
            ("cli scan --wideband + scan_wideband against the cpu",
             "fused_channelize", lambda: _scan_wideband_run(scan, want,
                                                            device)),
            ("cli scan (stepped)", None, lambda: _scan_stepped_run(scan)),
            ("cli waterfall", None, lambda: _waterfall_run(scan, tmp,
                                                           device)),
            ("cli tui (headless)", None,
             lambda: _tui_run(listen, frames["n"])),
            ("cli listen with a device fault", None,
             lambda: _fault_run(listen)))
        for tag, wrapper, run in runs:
            for name, n in _path(tag, wrapper, run).items():
                launches[name] += n
    return launches


def phase_timing_operator(device, card: str) -> None:
    """The receive loop per 131,072-sample chunk against its 54.6 ms of
    air, with its device busy share; one wideband sweep, its K5 + tail
    front and its host decode; the stepped scan per probed channel and the
    SignalProcessor construction in it (host clock around synchronized
    calls, busy from torch.profiler)."""
    import numpy as np
    import torch
    from tetraear_tpu_torch.io.replay import FileReplaySource
    from tetraear_tpu_torch.models.multicarrier import (
        MulticarrierDecoder, StagedMulticarrierFrontend)
    from tetraear_tpu_torch.models.receiver import SignalProcessor
    from tetraear_tpu_torch.signal.scanner import FrequencyScanner
    from tetraear_tpu_torch.ui.capture_loop import CaptureLoop

    air_ms = CHUNK / 2.4e6 * 1e3
    with tempfile.TemporaryDirectory() as tmp_name:
        listen, _, scan, _ = _captures(Path(tmp_name))

        class Timed(FileReplaySource):
            """Replay that notes the host clock at every read: a chunk's
            time is the gap between two reads."""
            stamps: list = []

            def read_samples(self, num_samples):
                torch.cuda.synchronize()
                self.stamps.append(time.perf_counter())
                return super().read_samples(num_samples)

        def loop_run(chunks: int) -> list:
            Timed.stamps = []
            loop = CaptureLoop(Timed(listen, loop=True), auto_decrypt=False,
                               always_decode=True, afc=False, device=device)
            loop.run(max_chunks=chunks)
            return np.diff(Timed.stamps)

        loop_run(3)
        gaps = loop_run(21)[1:]          # a chunk's start-up left out
        ms = float(np.median(gaps)) * 1e3
        busy_ms, top = _device_busy_ms(lambda: loop_run(11), iters=1)
        busy = ("not measured" if busy_ms is None else
                f"{busy_ms / 11:.3f} ms a chunk ({busy_ms / 11 / ms:.1%}); "
                "top " + ", ".join(f"{k[:36]} {v / 11:.3f}"
                                   for k, v in top[:3]))
        print(f"[timing] {card}: listen loop (CaptureLoop, ref-compat, "
              f"replay) {ms:.3f} ms per {CHUNK}-sample chunk (median of "
              f"{len(gaps)}; {gaps.min() * 1e3:.3f}..{gaps.max() * 1e3:.3f})"
              f" against {air_ms:.1f} ms of air = {air_ms / ms:.1f}x real "
              f"time; device busy {busy}")

        x = np.fromfile(scan, np.complex64)
        sc = FrequencyScanner(_FixedSource(x), settle_s=0.0, device=device)

        def host_ms(fn, iters: int = 3) -> float:
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) / iters * 1e3
        center = SCAN_CENTER_MHZ * 1e6
        result = sc.scan_wideband(center)
        hot = [r for r in result if r["power_db"] > -70]
        sweep_ms = host_ms(lambda: sc.scan_wideband(center))
        busy_ms, top = _device_busy_ms(lambda: sc.scan_wideband(center),
                                       iters=1)
        offs = np.array([r["frequency"] - center for r in hot], np.float32)
        mc = StagedMulticarrierFrontend.from_offsets(offs, device=device)
        xd = torch.as_tensor(x[:SCAN_USABLE], device=device)
        front_ms = _time_ms(lambda: mc(xd), 10)
        res = mc(xd)
        dec_ms = host_ms(lambda: MulticarrierDecoder(
            len(hot), device=device).decode(res))
        busy = ("not measured" if busy_ms is None else
                f"{busy_ms:.3f} ms ({busy_ms / sweep_ms:.1%}); top "
                + ", ".join(f"{k[:36]} {v:.3f}" for k, v in top[:3]))
        print(f"[timing] {card}: scan --wideband sweep (n={1 << 20}, "
              f"{len(result)} channels, {len(hot)} hot) {sweep_ms:.3f} ms "
              f"per sweep; K5 + tail front alone ({len(hot)} carriers, "
              f"n={SCAN_USABLE}) {front_ms:.3f} ms; host decode of the hot "
              f"channels {dec_ms:.3f} ms; device busy {busy}")
        sweep = scan_channels_hz().astype(np.float32)
        mc95 = StagedMulticarrierFrontend.from_offsets(sweep, device=device)
        print(f"[timing] {card}: the same front with every channel of the "
              f"sweep hot ({len(sweep)} carriers): "
              f"{_time_ms(lambda: mc95(xd), 5):.3f} ms")
        del xd, res, mc, mc95

        src = FileReplaySource(scan, loop=True)
        src.open()
        step = FrequencyScanner(src, settle_s=0.0, device=device)
        freqs = [center + k * 25e3 for k in range(-2, 3)]
        probe_ms = host_ms(lambda: [step.scan_frequency(f) for f in freqs],
                           2) / len(freqs)
        build_ms = host_ms(lambda: SignalProcessor(sample_rate=2.4e6,
                                                   device=device), 20)
        busy_ms, _ = _device_busy_ms(lambda: step.scan_frequency(center),
                                     iters=2)
        print(f"[timing] {card}: stepped scan {probe_ms:.3f} ms per probed "
              f"channel (262,144 samples); of it the SignalProcessor "
              f"construction (FIR design + taps to the card) {build_ms:.3f} "
              f"ms ({build_ms / probe_ms:.1%}); device busy "
              + ("not measured" if busy_ms is None
                 else f"{busy_ms:.3f} ms ({busy_ms / probe_ms:.1%})"))
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
    from tetraear_tpu_torch.utils.synth import planted_single
    x, text = planted_single(profile)
    with tempfile.TemporaryDirectory() as tmp:
        iq = Path(tmp) / "planted.cf32"
        out = Path(tmp) / "planted_frames.jsonl"
        np.asarray(x, np.complex64).view(np.float32).tofile(iq)
        rc = _cli(["decode", str(iq), "--profile", profile, "-o", str(out)])
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
    plain PyTorch but for the etsi link's Viterbi kernel)."""
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


def phase_timing_single(device, card: str) -> float:
    """Each profile's block demodulator on one CLI chunk (CUDA events, input
    already on the card), its device busy share, the IIR's parts, the
    host decoder and the Viterbi channel decode; -> the ref-compat
    Frontend's ms a chunk."""
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
        if profile == "ref-compat":
            compat_ms = ms
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
    return compat_ms


# --- 7. pod: the sharded receive (tetraear_tpu_torch/parallel/) -----------

POD_C = 96                   # the full band of one 2.4 MS/s receiver
POD_T = 8_320_000            # 64,000 x 130 = 20,800 x 400 samples (3.47 s)
POD_T_RP = 8_311_680         # 1,332 x 6,240: the real-pair step's grid, cut
                             # into 2 time shards (1,333 x 6,240 is odd)
POD_PLANTED = (5, 48, 90)    # the pod captures' text channels
POD_CAPTURES = ("x", "x_rp", "x_cells", "offsets", "offsets_rp")
POD_STEPS = ("staged", "fused", "realpair")
POD_HALOS = {"staged": 17_160, "fused": 17_160, "realpair": 18_720,
             "etsi": 17_200}         # the builders' default halos


def pod_captures(c: int = POD_C, n: int = POD_T,
                 n_rp: int = POD_T_RP) -> dict:
    """The pod phase's captures at 2.4 MS/s (numpy): "x", the SDS text
    "[TXT] POD CH k" on channels POD_PLANTED of carrier_grid(c)
    ("offsets"), "x_rp" the same on the real-pair grid (k - c // 2) x
    25 kHz ("offsets_rp"), each over complex noise of 0.01 a sample, and
    "x_cells", ETSI downlink cells on those channels of carrier_grid(c)
    (utils.synth.planted_cells: MNC 100 + k, "[TXT] CELL k MSG")."""
    import numpy as np
    from tetraear_tpu_torch.ops.channelizer import carrier_grid
    from tetraear_tpu_torch.utils.synth import planted, planted_cells
    caps = {"offsets": carrier_grid(c),
            "offsets_rp": ((np.arange(c) - c // 2) * 25e3
                           ).astype(np.float32)}
    frames = n // (255 * 130) + 2        # a frame: 255 symbols of 130
    rng = np.random.default_rng(7)
    for key, grid, length in (("x", caps["offsets"], n),
                              ("x_rp", caps["offsets_rp"], n_rp)):
        x = planted({float(grid[k]): (k, f"POD CH {k}")
                     for k in POD_PLANTED}, 2.4e6, frames)[:length]
        noise = rng.standard_normal((2, length)).astype(np.float32)
        caps[key] = (x + (0.01 / np.sqrt(2)) * (noise[0] + 1j * noise[1])
                     ).astype(np.complex64)
    cells, _ = planted_cells(POD_PLANTED, c, slots=n // 34_000 + 2)
    caps["x_cells"] = cells[:n]
    return caps


def pod_paths(mesh, caps: dict, device, decode: bool) -> tuple:
    """The four sharded steps on `mesh` through the entry points a user
    calls, each path with the launch counts set to 0 just before and read
    just after; K5 must launch on the staged and etsi paths:
    `ShardedReceiver` (the staged step, its `decode` with decode=True),
    `build_sharded_step_fused`, `build_sharded_step_realpair` and
    `ShardedDownlinkReceiver` (the etsi step, its `decode`).  Returns
    (the global results as numpy, {"staged" / "etsi": frames},
    launches)."""
    from tetraear_tpu_torch.parallel.mesh import TIME_AXIS
    from tetraear_tpu_torch.parallel.sharded import (
        ShardedDownlinkReceiver, ShardedReceiver, build_sharded_step_fused,
        build_sharded_step_realpair, gather_result, realpair_shard_inputs,
        shard_inputs)
    n_t = mesh.size(TIME_AXIS)
    t_local = len(caps["x"]) // n_t
    out, frames = {}, {}

    def keep(tag, res):
        for k, v in res._asdict().items():
            out[f"{tag}_{k}"] = v.cpu().numpy()

    def staged():
        rx = ShardedReceiver(mesh, device=device)
        res = rx(caps["x"], caps["offsets"])
        keep("staged", res)
        if decode:
            frames["staged"] = rx.decode(res, t_local)

    def fused():
        xs, _ = shard_inputs(mesh, caps["x"], caps["offsets"], device)
        run = build_sharded_step_fused(mesh, caps["offsets"], device=device)
        keep("fused", gather_result(mesh, run(xs)))

    def realpair():
        run, halo = build_sharded_step_realpair(mesh, device=device)
        keep("realpair", gather_result(mesh, run(*realpair_shard_inputs(
            mesh, caps["x_rp"], caps["offsets_rp"], halo, 2.4e6,
            device=device))))

    def etsi():
        dl = ShardedDownlinkReceiver(mesh, len(caps["offsets"]),
                                     device=device)
        res = dl(caps["x_cells"], caps["offsets"])
        out["etsi_stitched"] = dl.stitch(res, t_local)
        out["etsi_best_phase"] = res.best_phase.cpu().numpy()
        if decode:
            frames["etsi"] = dl.decode(res, t_local)

    launches = dict.fromkeys(KERNELS, 0)
    shape = f"({mesh.size('carrier')}, {n_t}) mesh"
    # K5 on a card; on the cpu the staged chain runs its plain version
    k5 = "fused_channelize" if device.type == "cuda" else None
    for tag, wrapper, run in (
            ("ShardedReceiver (staged step)", k5, staged),
            ("fused step", None, fused), ("real-pair step", None, realpair),
            ("ShardedDownlinkReceiver (etsi step)", k5, etsi)):
        for name, k in _path(f"pod {tag}, {shape}, {device}", wrapper,
                             run).items():
            launches[name] += k
    return out, frames, launches


def pod_owned(bits, halo: int, t_local: int, sps: int = 13):
    """(C, n_time, seg) extended segments -> (C, n_time x own) global
    stream of each shard's owned bits (ShardedReceiver.decode's region)."""
    import numpy as np
    h = 2 * ((halo // 10) // sps)
    own = 2 * ((t_local // 10) // sps)
    return np.concatenate([bits[:, k, h:h + own]
                           for k in range(bits.shape[1])], axis=-1)


def pod_agree(tag: str, got, want, edge: int = 16) -> None:
    """Bits (C, B) against (C, B'), on the common length less `edge` bits
    at each end of the stream: the planted channels equal, every other at
    least 0.995 (near-zero symbols flip under another sum order), as the
    tests and the reference's own hold them."""
    import numpy as np
    n = min(got.shape[-1], want.shape[-1]) - edge
    agree = (got[:, edge:n] == want[:, edge:n]).mean(axis=-1)
    planted = agree[list(POD_PLANTED)]
    others = np.delete(agree, list(POD_PLANTED))
    ok = (planted == 1.0).all() and (others >= 0.995).all()
    print(f"[pod] {tag}: {n - edge} bits a channel; planted channels "
          f"{POD_PLANTED} agreement {planted.min():.6f}, the other "
          f"{len(others)} min {others.min():.6f} mean {others.mean():.6f}: "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        fail("pod", f"{tag}: decisions differ (worst channel "
                    f"{int(np.argmin(agree))}: {agree.min():.6f})")


def pod_soft_agree(tag: str, got, want, edge: int = 200) -> float:
    """Stitched LLRs (C, B) against (C, B') on the planted channels,
    `edge` LLRs in from each end of the stream: within 1e-3 (f32
    rounding behind the channelizer) and the confident signs equal."""
    import numpy as np
    n = min(got.shape[-1], want.shape[-1]) - edge
    a = got[list(POD_PLANTED), edge:n]
    b = want[list(POD_PLANTED), edge:n]
    err = float(np.abs(a - b).max())
    conf = np.abs(b) > 1e-3
    signs = bool(np.array_equal(np.sign(a)[conf], np.sign(b)[conf]))
    ok = err <= 1e-3 and signs
    print(f"[pod] {tag}: planted channels' LLRs max|diff| {err:.3e} "
          f"(bound 1e-3), confident signs {'equal' if signs else 'DIFFER'}"
          f": {'ok' if ok else 'FAIL'}")
    if not ok:
        fail("pod", f"{tag}: LLRs differ")
    return err


def pod_frames_check(tag: str, frames: dict) -> None:
    """ShardedReceiver.decode: every sync emitted once, each planted text
    on its channel, and no frame of it twice (the host decoder also takes
    false syncs inside a channel's payload bits, as the reference's does,
    so frame numbers may repeat on other frames);
    ShardedDownlinkReceiver.decode: each planted cell's text and identity
    on its channel."""
    _check_texts(f"{tag} ShardedReceiver.decode",
                 {k: f"[TXT] POD CH {k}" for k in POD_PLANTED},
                 _texts(frames["staged"]))
    for c, fc in enumerate(frames["staged"]):
        pos = [f["sync_position"] for f in fc]
        if len(pos) != len(set(pos)):
            fail("pod", f"{tag}: channel {c} emitted a sync twice")
    n = []
    for k in POD_PLANTED:
        nums = [f["number"] for f in frames["staged"][k]
                if f.get("sds_message") == f"[TXT] POD CH {k}"]
        if len(nums) != len(set(nums)):
            fail("pod", f"{tag}: channel {k} emitted a frame twice")
        n.append(len(nums))
    print(f"[pod] {tag}: ShardedReceiver.decode: {n} frames with their "
          f"texts on channels {POD_PLANTED}, each once; "
          f"{sum(map(len, frames['staged']))} frames on all channels, no "
          "sync position twice")
    for k in POD_PLANTED:
        fc = frames["etsi"][k]
        texts = [f.sds_message for f in fc if f.sds_message]
        mncs = {f.sync_pdu.mnc for f in fc if f.sync_pdu}
        ok = f"[TXT] CELL {k} MSG" in texts and mncs == {100 + k}
        print(f"[pod] {tag}: ShardedDownlinkReceiver.decode channel {k}: "
              f"{len(fc)} frames, {texts.count(f'[TXT] CELL {k} MSG')} with "
              f"its text, MNC {sorted(mncs)}: {'ok' if ok else 'FAIL'}")
        if not ok:
            fail("pod", f"{tag}: cell {k} not decoded")


def pod_unsharded(caps: dict, device) -> dict:
    """The unsharded frontends' bits on the same captures (StagedMulti-
    carrierFrontend, MulticarrierFrontend(conv="fused"), the real-pair
    block) and MulticarrierDownlinkReceiver.demodulate's LLRs, numpy."""
    import torch
    from tetraear_tpu_torch.models.downlink import (
        MulticarrierDownlinkReceiver)
    from tetraear_tpu_torch.models.multicarrier import (
        MulticarrierFrontend, StagedMulticarrierFrontend)
    from tetraear_tpu_torch.models.realpair import (_as_pair,
                                                    _realpair_block,
                                                    staged_state)
    x = torch.as_tensor(caps["x"], device=device)
    ref = {}
    mc = StagedMulticarrierFrontend.from_offsets(caps["offsets"],
                                                 device=device)
    ref["staged"] = mc.demod(mc.channelize(x))[0]
    mc = MulticarrierFrontend.from_offsets(caps["offsets"], device=device,
                                           conv="fused")
    ref["fused"] = mc.demod(mc.channelize(x))[0]
    st = staged_state(caps["offsets_rp"], table=True)
    dev = lambda a: torch.as_tensor(a, device=device)
    ref["realpair"] = _realpair_block(
        _as_pair(caps["x_rp"], device), dev(st.table), dev(st.taps_d),
        dev(st.taps_c), st.decim, 13).bits
    soft, _counts = MulticarrierDownlinkReceiver(
        len(caps["offsets"]), device=device).demodulate(caps["x_cells"])
    ref["etsi"] = soft.reshape(soft.shape[0], -1)
    return {k: v.cpu().numpy() for k, v in ref.items()}


def pod_against(tag: str, got: dict, want: dict, t_total: dict,
                n_time: int) -> None:
    """A run's owned interiors against another's (bits, LLRs) and, where
    `want` holds a run's results too, its best phases."""
    import numpy as np
    for step in POD_STEPS:
        a = pod_owned(got[f"{step}_bits"], POD_HALOS[step],
                      t_total[step] // n_time)
        b = want[step] if step in want else want[f"{step}_owned"]
        pod_agree(f"{tag} {step}", a, b)
    pod_soft_agree(f"{tag} etsi", got["etsi_stitched"],
                   want["etsi"] if "etsi" in want else want["etsi_stitched"])
    for step in (*POD_STEPS, "etsi"):
        key = f"{step}_best_phase"
        if key in want:
            same = (got[key][:, :1] == want[key][:, :1]).all(axis=1)
            print(f"[pod] {tag} {step}: best phase equal on "
                  f"{int(same.sum())} of {len(same)} channels"
                  + ("" if same.all() else
                     f"; differs on {np.flatnonzero(~same).tolist()}"))
            if not same.all():
                fail("pod", f"{tag} {step}: best phases differ")
        if (got[key] != got[key][:, :1]).any():
            fail("pod", f"{tag} {step}: best phase differs between the "
                        "time shards")


def pod_k5_starts(device) -> float:
    """K5 against its plain version (and a float64 oracle of the same f32
    phases on 256 outputs) at the pod's shard starts: the extended block
    of the first time shard (start -17,160) and of the last (start
    4,142,840) of a 2-shard cut, and the (1, 1) mesh's extended block,
    at C = 96 and at the 48 of each carrier half."""
    import numpy as np
    import torch
    from tetraear_tpu_torch.models.realpair import staged_state
    from tetraear_tpu_torch.ops.channelizer import carrier_grid
    from tetraear_tpu_torch.ops.kernels import fused_channelize as k5
    halo = 17_160
    half = POD_T // 2
    state = staged_state(carrier_grid(POD_C))
    taps = torch.as_tensor(state.taps_d, device=device)
    fs = state.sample_rate_hz
    worst = 0.0
    for lo, hi, n, start in ((0, 96, POD_T + 2 * halo, -halo),
                             (0, 48, half + 2 * halo, -halo),
                             (48, 96, half + 2 * halo, half - halo),
                             (0, 96, half + 2 * halo, half - halo)):
        offs = torch.as_tensor(state.offsets_hz[lo:hi], device=device)
        gen = torch.Generator(device=device).manual_seed(start & 0xFFFF)
        x = torch.randn(n, dtype=torch.complex64, device=device,
                        generator=gen) * 0.1
        got = _launched("fused_channelize", lambda: k5.fused_channelize(
            x, offs, fs, state.decim, taps, start))
        want = k5.fused_channelize_plain(x, offs, fs, state.decim, taps,
                                         start)
        m_idx = np.random.default_rng(n).choice(got.shape[1], 256,
                                                replace=False)
        oracle = _k5_oracle(x, offs, taps, fs, state.decim, start, m_idx)
        err = np.abs(got[:, m_idx].cpu().numpy() - oracle).max()
        tag = (f"K5 pod shard C={hi - lo} (channels {lo}..{hi - 1}) "
               f"n={n} start={start}")
        print(f"[kernel] {tag}: on 256 outputs max|K5-f64 oracle| = "
              f"{err:.3e}")
        worst = max(worst, _held(tag, "K5", got, want, TOL))
        del x, got, want
    return worst


def _pod_steps(mesh, caps: dict, device) -> dict:
    """step -> (this rank's step, its local inputs), made once, for the
    timing."""
    from tetraear_tpu_torch.parallel.sharded import (
        build_sharded_step, build_sharded_step_etsi, build_sharded_step_fused,
        build_sharded_step_realpair, realpair_shard_inputs, shard_inputs)
    xs, offs = shard_inputs(mesh, caps["x"], caps["offsets"], device)
    xe, _ = shard_inputs(mesh, caps["x_cells"], caps["offsets"], device)
    run_rp, halo_rp = build_sharded_step_realpair(mesh, device=device)
    rp_in = realpair_shard_inputs(mesh, caps["x_rp"], caps["offsets_rp"],
                                  halo_rp, 2.4e6, device=device)
    run_e, _ = build_sharded_step_etsi(mesh, device=device)
    return {"staged": (build_sharded_step(mesh, device=device), (xs, offs)),
            "fused": (build_sharded_step_fused(mesh, caps["offsets"],
                                               device=device), (xs,)),
            "realpair": (run_rp, rp_in), "etsi": (run_e, (xe, offs))}


def pod_timing_11(mesh, caps: dict, device, card: str) -> dict:
    """7e at the (1, 1) mesh: each step, CUDA events, on one 8.32 M-sample
    block already on the card, beside the unsharded frontend on the same
    block (the gap: the halo concat, the psum and the gather, which are
    no-ops of one rank), with its torch.profiler busy share."""
    import torch
    from tetraear_tpu_torch.models.downlink import (
        MulticarrierDownlinkReceiver)
    from tetraear_tpu_torch.models.multicarrier import (
        MulticarrierFrontend, StagedMulticarrierFrontend)
    from tetraear_tpu_torch.models.realpair import (_as_pair,
                                                    _realpair_block,
                                                    staged_state)
    from tetraear_tpu_torch.parallel.sharded import gather_result
    steps = _pod_steps(mesh, caps, device)
    x, xe = steps["staged"][1][0], steps["etsi"][1][0]
    staged = StagedMulticarrierFrontend.from_offsets(caps["offsets"],
                                                     device=device)
    fused = MulticarrierFrontend.from_offsets(caps["offsets"], device=device,
                                              conv="fused")
    st = staged_state(caps["offsets_rp"], table=True)
    dev = lambda a: torch.as_tensor(a, device=device)
    x_ri, table = _as_pair(caps["x_rp"], device), dev(st.table)
    taps_d, taps_c = dev(st.taps_d), dev(st.taps_c)
    dl = MulticarrierDownlinkReceiver(len(caps["offsets"]), device=device)
    unsharded = {
        "staged": lambda: staged.demod(staged.channelize(x)),
        "fused": lambda: fused.demod(fused.channelize(x)),
        "realpair": lambda: _realpair_block(x_ri, table, taps_d, taps_c,
                                            st.decim, 13),
        "etsi": lambda: dl.demodulate(xe)}
    names = {"staged": "StagedMulticarrierFrontend channelize + demod front",
             "fused": "MulticarrierFrontend(conv='fused') channelize + demod",
             "realpair": "the real-pair block (k = 0)",
             "etsi": "MulticarrierDownlinkReceiver.demodulate"}
    times = {}
    for step, (run, args) in steps.items():
        fn = lambda run=run, args=args: gather_result(mesh, run(*args))
        ms = _time_ms(fn, 5, warmup=1)
        ref_ms = _time_ms(unsharded[step], 5, warmup=1)
        peak = _peak_mib(fn)
        busy_ms, top = _device_busy_ms(fn, iters=2)
        busy = ("not measured" if busy_ms is None else
                f"{busy_ms:.3f} ms ({busy_ms / ms:.1%}); top kernel "
                f"{top[0][1]:.3f} ms {top[0][0][:50]}")
        n = (caps["x_rp"] if step == "realpair" else x).shape[0]
        times[step] = {"ms": ms, "unsharded_ms": ref_ms}
        print(f"[timing] {card}: pod {step} step, (1, 1) mesh, C = "
              f"{len(caps['offsets'])}, n = {n}: {ms:.3f} ms per block = "
              f"{n / (ms / 1e3):,.0f} samples/s; {names[step]} on the same "
              f"block {ref_ms:.3f} ms (step - unsharded {ms - ref_ms:+.3f} "
              f"ms); peak device memory {peak:.0f} MiB; device busy {busy}")
    return times


def _pod_rank_timing(mesh, caps: dict, device) -> dict:
    """7e in every rank of the (2, 2) world (the collectives need them
    all): each step with its gather, host clock around synchronized
    calls, and the exchange alone (the halo exchange of the block and
    the gather of the step's result)."""
    import torch
    from tetraear_tpu_torch.parallel.halo import extend_with_halo
    from tetraear_tpu_torch.parallel.sharded import gather_result

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    def host_ms(fn, iters=3):
        fn()
        sync()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        sync()
        return (time.perf_counter() - t0) / iters * 1e3

    times = {}
    for step, (run, args) in _pod_steps(mesh, caps, device).items():
        ms = host_ms(lambda: gather_result(mesh, run(*args)))
        local = run(*args)
        halo = POD_HALOS[step]

        def exchange():
            extend_with_halo(args[0], halo, halo, mesh)
            gather_result(mesh, local)
        before = mesh.staged_bytes
        exchange()
        staged = mesh.staged_bytes - before
        times[step] = {"ms": ms, "exchange_ms": host_ms(exchange),
                       "staged_bytes": staged}
    return times


def _pod_rank(tmp: str) -> None:
    """A rank of 7b's world (4 ranks on the one card, gloo): the four
    steps on a (2, 2) mesh; every rank writes its launch counts, rank 0
    the gathered results and the (2, 2) times."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from tetraear_tpu_torch.entry import rank_device
    from tetraear_tpu_torch.parallel.mesh import make_mesh
    tmp = Path(tmp)
    rank = dist.get_rank()
    device_type = json.loads((tmp / "pod.json").read_text())["device_type"]
    device = rank_device(device_type, 0)
    caps = {k: np.load(tmp / f"{k}.npy") for k in POD_CAPTURES}
    mesh = make_mesh(2, 2, device_type=device_type)
    out, _, launches = pod_paths(mesh, caps, device, decode=False)
    (tmp / f"launches_{rank}.json").write_text(json.dumps(launches))
    staged_bytes = mesh.staged_bytes
    times = _pod_rank_timing(mesh, caps, device)
    if rank == 0:
        np.savez(tmp / "pod22.npz", **out)
        (tmp / "times22.json").write_text(json.dumps(
            {"steps": times, "staged_bytes": staged_bytes}))


def _nccl_probe_rank() -> None:
    """A rank of a 4-rank nccl world on the one card: one all_reduce."""
    import torch
    import torch.distributed as dist
    torch.cuda.set_device(0)
    t = torch.ones(1, device="cuda:0")
    dist.all_reduce(t)


def pod_nccl_probe() -> None:
    """7b: nccl takes one rank a card; show what it says to four ranks on
    the one card."""
    from tetraear_tpu_torch.entry import RankFailed, launch
    try:
        launch(4, "cuda", _nccl_probe_rank, backend="nccl", timeout=150)
    except RankFailed as e:
        lines = [ln.strip() for ln in str(e).splitlines()
                 if "Duplicate GPU" in ln or "ncclInvalidUsage" in ln
                 or "Error" in ln]
        print("[pod] nccl, 4 ranks on one card: refused: "
              + (" | ".join(dict.fromkeys(lines)) or str(e)[:400])[:600])
        return
    print("[pod] nccl, 4 ranks on one card: accepted (the run goes on "
          "over gloo all the same)")


def pod_four_ranks(caps: dict, device_type: str, tmp: Path) -> tuple:
    """7b: 4 ranks on the one card over gloo, (2, 2) mesh; returns
    (rank 0's gathered results, every rank's launches, the (2, 2)
    times)."""
    import numpy as np
    from tetraear_tpu_torch.entry import launch
    for k in POD_CAPTURES:
        np.save(tmp / f"{k}.npy", caps[k])
    (tmp / "pod.json").write_text(json.dumps({"device_type": device_type}))
    launch(4, device_type, _pod_rank, str(tmp), backend="gloo",
           timeout=600)
    got = dict(np.load(tmp / "pod22.npz"))
    ranks = [json.loads((tmp / f"launches_{r}.json").read_text())
             for r in range(4)]
    return got, ranks, json.loads((tmp / "times22.json").read_text())


def phase_pod(device, card: str) -> tuple:
    """7: the pod-scale receive (module docstring); returns (launches of
    the main paths, K5's largest error at the shard starts)."""
    import numpy as np
    import torch.distributed as dist
    from tetraear_tpu_torch.entry import dryrun_multichip, entry
    from tetraear_tpu_torch.parallel.distributed import (
        initialize_distributed)
    from tetraear_tpu_torch.parallel.mesh import make_mesh
    t0 = time.perf_counter()
    caps = pod_captures()
    print(f"[pod] captures: C = {POD_C}, n = {POD_T} (real-pair "
          f"{POD_T_RP}), texts on channels {POD_PLANTED}, made in "
          f"{time.perf_counter() - t0:.1f} s")
    k5_err = pod_k5_starts(device)

    # (a) a world of one rank, nccl, (1, 1) mesh
    initialize_distributed("cuda")
    mesh = make_mesh(1, 1, device_type="cuda")
    print(f"[pod] world of {dist.get_world_size()}, {dist.get_backend()}: "
          f"{mesh}")
    got, frames, launches = pod_paths(mesh, caps, device, decode=True)
    pod_frames_check("(1, 1)", frames)
    ref = pod_unsharded(caps, device)
    t_total = {"staged": POD_T, "fused": POD_T, "realpair": POD_T_RP}
    pod_against("(1, 1) against the unsharded frontends", got, ref,
                t_total, 1)
    pod_timing_11(mesh, caps, device, card)
    dist.destroy_process_group()

    # (b) 4 ranks on the one card, (2, 2) mesh
    pod_nccl_probe()
    with tempfile.TemporaryDirectory() as tmp:
        got22, ranks, times = pod_four_ranks(caps, "cuda", Path(tmp))
    for r, counts in enumerate(ranks):
        if counts["fused_channelize"] == 0:
            fail("pod", f"rank {r} of the (2, 2) world never launched K5")
    print(f"[pod] (2, 2), 4 ranks, gloo: K5 launches by rank "
          f"{[c['fused_channelize'] for c in ranks]}; bytes staged between "
          f"the card and the host by the steps' collectives "
          f"{times['staged_bytes']:,} (rank 0)")
    want = dict(got)
    for step in POD_STEPS:
        want[f"{step}_owned"] = pod_owned(got[f"{step}_bits"],
                                          POD_HALOS[step], t_total[step])
    pod_against("(2, 2) against (1, 1)", got22, want, t_total, 2)
    for step, t in times["steps"].items():
        print(f"[timing] {card}: pod {step} step, (2, 2) mesh, four ranks "
              f"sharing one card over host-staged gloo (not a scaling "
              f"number): {t['ms']:.3f} ms per block with the gather (rank "
              f"0, host clock); the exchange alone (halo exchange of the "
              f"block + gather of the result) {t['exchange_ms']:.3f} ms = "
              f"{t['exchange_ms'] / t['ms']:.1%}, {t['staged_bytes']:,} "
              f"bytes staged a call")

    # (d) the entry points
    def run_entry():
        fn, args = entry(device)
        res = fn(*args)
        if not all(np.isfinite(v.float().cpu().numpy()).all()
                   for v in res):
            fail("pod", "entry() gave non-finite values")
        print(f"[pod] entry({device}): "
              f"{ {k: tuple(v.shape) for k, v in res._asdict().items()} }")
    for name, k in _path("pod entry()", "fused_channelize",
                         run_entry).items():
        launches[name] += k
    t1 = time.perf_counter()
    dryrun_multichip(1, "cuda")
    print(f"[pod] dryrun_multichip(1, 'cuda'): ok in "
          f"{time.perf_counter() - t1:.1f} s")
    return launches, k5_err


# --- 8. tools: the port's twins of the repo's tools/*.py --------------------

TOOL_FIXTURES = ("clean.cf32", "encrypted.cf32")
TOOL_CHUNK = 256 * 1024        # the capture tools' CaptureLoop chunk
TOOL_BLOCKS = (1040 * 130, POD_T)   # bench_scaling's default, phase 7's
K5_TOOL_HALOS = {"ref": 17_160, "etsi": 1_600}
RUN_ID = re.compile(rb"\d{8}_\d{6}")


def _tool_check(tag: str, cond: bool, msg: str) -> None:
    print(f"[tools] {tag}: {msg}: {'ok' if cond else 'FAIL'}")
    if not cond:
        fail("tools", f"{tag}: {msg}")


def _tool_out(main, argv: list, **kwargs) -> tuple:
    """(exit code, stdout lines) of a tool's main(argv)."""
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv, **kwargs)
    return rc, buf.getvalue().splitlines()


def _tool_files(root: Path) -> dict:
    """{name: bytes} of every file a tool wrote under root, run ids cut."""
    return {RUN_ID.sub(b"RUN", str(p.relative_to(root)).encode()):
            RUN_ID.sub(b"RUN", p.read_bytes())
            for p in sorted(root.rglob("*")) if p.is_file()}


def tools_sweep(card: str) -> None:
    """sensitivity_sweep at its defaults on the card and on the cpu."""
    import torch
    from tetraear_tpu_torch.tools import sensitivity_sweep as ss
    runs = {}
    for dev in ("cuda", "cpu"):
        rows, verdicts, ms = [], [], []
        t = time.perf_counter()
        for row, v in ss.sweep(device=dev):
            if dev == "cuda":
                torch.cuda.synchronize()
            now = time.perf_counter()
            ms.append((now - t) * 1e3)
            t = now
            rows.append(row)
            verdicts.append(v)
        runs[dev] = rows, verdicts, ms
    rows, verdicts, ms = runs["cuda"]
    for row, v, v_cpu, t_card, t_cpu in zip(rows, verdicts, runs["cpu"][1],
                                           ms, runs["cpu"][2]):
        print(f"[tools] sensitivity_sweep {json.dumps(row)}; slots passed "
              f"per seed {[sum(map(bool, s)) for s in v]}")
        _tool_check(f"sensitivity_sweep {row['snr_wideband_db']} dB",
                    v == v_cpu, "every slot's CRC verdict equal to "
                                "--device cpu's")
        print(f"[timing] {card}: sensitivity_sweep "
              f"{row['snr_wideband_db']} dB (3 seeds of 12 slots, "
              f"DownlinkReceiver.receive each): {t_card:.1f} ms on the "
              f"card, {t_cpu:.1f} ms with --device cpu")
    _tool_check("sensitivity_sweep", rows == runs["cpu"][0],
                "JSON lines equal to --device cpu's")
    rate = {r["snr_wideband_db"]: r["crc_pass_rate"] for r in rows}
    _tool_check("sensitivity_sweep", rate[-6] >= 0.9 and rate[-12] >= 0.9
                and rate[-16] <= 0.5, f"the pinned curve (-6 dB "
                f"{rate[-6]}, -12 dB {rate[-12]} >= 0.9; -16 dB "
                f"{rate[-16]} <= 0.5)")


def tools_captures(tmp: Path, card: str) -> None:
    """make_fixture, then the four capture tools on the card and with
    --device cpu on the conformance fixtures and a 48-frame capture."""
    import os
    import numpy as np
    import torch
    from tetraear_tpu_torch.tools import (auto_capture, continuous_capture,
                                          decrypt_capture, listen_clear,
                                          make_fixture)
    fixtures = Path(__file__).resolve().parent / "tests" / "conformance" / \
        "fixtures"
    keys = Path(__file__).resolve().parent / "keys.example.txt"
    long_iq = tmp / "long.cf32"
    for out in (long_iq, tmp / "again.cf32"):
        rc, lines = _tool_out(make_fixture.main,
                              [str(out), "--frames", "48"])
        _tool_check("make_fixture", rc == 0, f"exit {rc}: {lines[-1]}")
    _tool_check("make_fixture", long_iq.read_bytes()
                == (tmp / "again.cf32").read_bytes(), "its IQ the same "
                "bytes in a second run")
    cases = [(tool, [str(fixtures / f)]) for f in TOOL_FIXTURES
             for tool in ("continuous_capture", "listen_clear",
                          "auto_capture", "decrypt_capture")]
    cases.append(("continuous_capture", [str(long_iq)]))
    modules = {"continuous_capture": continuous_capture,
               "listen_clear": listen_clear, "auto_capture": auto_capture,
               "decrypt_capture": decrypt_capture}
    extra = {"auto_capture": ["--attempts", "1", "--chunks-per-attempt",
                              "4", "--key-file", str(keys)],
             "decrypt_capture": ["-k", str(keys)]}
    here = os.getcwd()
    try:
        for k, (tool, iq) in enumerate(cases):
            argv = ["--iq-file", *iq, *extra.get(tool, [])]
            chunks = -(-np.fromfile(iq[0], np.complex64).size // TOOL_CHUNK)
            got = {}
            for dev in ("cuda", "cpu"):
                cwd = tmp / f"{k}-{dev}"
                cwd.mkdir()
                os.chdir(cwd)
                t0 = time.perf_counter()
                rc, lines = _tool_out(modules[tool].main,
                                      [*argv, "--device", dev])
                if dev == "cuda":
                    torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
                got[dev] = (rc, [RUN_ID.sub(b"RUN", line.encode())
                                 for line in lines], _tool_files(cwd))
                print(f"[timing] {card}: {tool} {Path(iq[0]).name} "
                      f"--device {dev}: {ms:.1f} ms for {chunks} chunk(s) "
                      f"= {ms / chunks:.1f} ms per 262,144-sample chunk, "
                      f"the loop's setup included")
            files = got["cuda"][2]
            _tool_check(f"{tool} {Path(iq[0]).name}",
                        got["cuda"] == got["cpu"], f"exit {got['cuda'][0]}, "
                        f"printed lines and {len(files)} files "
                        f"({sum(map(len, files.values()))} bytes) equal to "
                        f"--device cpu's")
            if tool == "continuous_capture":
                frames = sum(v.count(b"\n") for n, v in files.items()
                             if n.endswith(b".jsonl"))
                _tool_check(f"{tool} {Path(iq[0]).name}", frames > 0,
                            f"{frames} frames logged")
    finally:
        os.chdir(here)


def tools_bench(device, card: str) -> tuple:
    """bench_scaling spawned as a user runs it, then in a started world of
    one rank (counted: each run must launch K5), and K5 at each run's
    shape against its plain version; returns (launches, K5's largest
    error)."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from tetraear_tpu_torch.config import ReceiverConfig
    from tetraear_tpu_torch.ops.kernels import fused_channelize as k5
    from tetraear_tpu_torch.parallel.distributed import (
        initialize_distributed)
    from tetraear_tpu_torch.parallel.sharded import _staged_taps
    from tetraear_tpu_torch.tools import bench_scaling as bs
    t0 = time.perf_counter()
    rc, lines = _tool_out(bs.main, ["--iters", "2"])
    _tool_check("bench_scaling, spawned (entry.launch, nccl)", rc == 0 and
                lines[0] == "# backend=cuda devices=1" and len(lines) == 2,
                f"{lines} in {time.perf_counter() - t0:.1f} s")
    cfg = ReceiverConfig()
    taps, _ = _staged_taps(cfg, device)
    launches = None
    worst = 0.0
    initialize_distributed("cuda")
    try:
        for profile in ("ref", "etsi"):
            for block in TOOL_BLOCKS:
                argv = ["--profile", profile, "--per-device-samples",
                        str(block)]
                out = {}

                def run():
                    out["rc"], out["lines"] = _tool_out(bs.main, argv)
                counts = _path(f"bench_scaling --profile {profile} "
                               f"--per-device-samples {block}",
                               "fused_channelize", run)
                launches = counts if launches is None else {
                    k: launches[k] + v for k, v in counts.items()}
                row = json.loads(out["lines"][-1])
                _tool_check(f"bench_scaling {profile} {block}",
                            out["rc"] == 0 and row["mesh"] == [1, 1]
                            and row["samples_per_sec"] > 0,
                            f"exit {out['rc']}, {out['lines']}")
                print(f"[timing] {card}: bench_scaling --profile {profile} "
                      f"--per-device-samples {block}, (1, 1) mesh, nccl: "
                      f"{row['samples_per_sec']:,.1f} samples/s "
                      f"(= {block / row['samples_per_sec'] * 1e3:.3f} ms "
                      f"per step, the digest pull included)")
                # K5 at the run's shape: the block with its zero halos
                _, _, x, offsets = next(bs.block_inputs(1, block, profile))
                halo = K5_TOOL_HALOS[profile]
                xe = torch.zeros(x.size + 2 * halo, dtype=torch.complex64,
                                 device=device)
                xe[halo:halo + x.size] = torch.as_tensor(x, device=device)
                offs = torch.as_tensor(offsets, device=device)
                got = _launched("fused_channelize",
                                lambda: k5.fused_channelize(
                                    xe, offs, cfg.sample_rate_hz,
                                    cfg.decimation_factor, taps, -halo))
                want = k5.fused_channelize_plain(
                    xe, offs, cfg.sample_rate_hz, cfg.decimation_factor,
                    taps, -halo)
                worst = max(worst, _held(
                    f"K5 bench_scaling --profile {profile} C=1 "
                    f"n={xe.numel()} start={-halo}", "K5", got, want, TOL))
                del xe, got, want
    finally:
        dist.destroy_process_group()
    if not np.isfinite(worst):
        fail("tools", "K5 gave non-finite values")
    return launches, worst


def phase_tools(device, card: str) -> tuple:
    """8: the port's tools (module docstring); returns (launches of their
    paths, K5's largest error at the bench's shapes)."""
    from tetraear_tpu_torch.ops.kernels import launches as counts
    t0 = time.perf_counter()
    total = dict.fromkeys(counts(), 0)

    def add(c):
        for k, v in c.items():
            total[k] += v
    add(_path("sensitivity_sweep", None, lambda: tools_sweep(card)))
    with tempfile.TemporaryDirectory() as tmp:
        add(_path("capture tools", None,
                  lambda: tools_captures(Path(tmp), card)))
    bench, k5_err = tools_bench(device, card)
    add(bench)
    print(f"[tools] phase 8 in {time.perf_counter() - t0:.1f} s")
    return total, k5_err


# --- 9. comm: the communication audit (tools/comm_analysis.py's twin) -------

COMM_SCALE = 8               # the audit's default block: 1,081,600 samples
COMM_MESHES = ((2, 2), (1, 4))
COMM_STEP = "etsi"           # the four-rank world's step (K5 on the card)


def _comm_check(tag: str, cond: bool, msg: str) -> None:
    print(f"[comm] {tag}: {msg}: {'ok' if cond else 'FAIL'}")
    if not cond:
        fail("comm", f"{tag}: {msg}")


def comm_world_of_one(card: str) -> dict:
    """The audit in a started world of one (nccl, (1, 1)), counted: its
    three steps at --scale 8; returns the launches."""
    import torch.distributed as dist
    from tetraear_tpu_torch.parallel.distributed import (
        initialize_distributed)
    from tetraear_tpu_torch.tools import comm_analysis as ca
    argv = ["--devices", "1", "--scale", str(COMM_SCALE)]
    out = {}

    def run():
        out["rc"], out["lines"] = _tool_out(ca.main, argv)
    initialize_distributed("cuda")
    try:
        launches = _path("comm_analysis " + " ".join(argv),
                         "fused_channelize", run)
    finally:
        dist.destroy_process_group()
    rows = [json.loads(line) for line in out["lines"]]
    _comm_check("comm_analysis, world of one", out["rc"] == 0 and
                [(r["variant"], r["mesh"]) for r in rows]
                == [(s, "1x1") for s in ca.STEPS], f"exit {out['rc']}, "
                f"{len(rows)} rows")
    want = {"fused": 52, "realpair": 52, "etsi": 16}
    for r in rows:
        print(f"[comm] {r['device']}: {json.dumps(r)}")
        _comm_check(f"{r['variant']} (1, 1)", r["device"] == card
                    and r["backend"] == "nccl"
                    and r["link_source"] == "unmeasured"
                    and r["eff_no_overlap"] is None
                    and r["t_compute_s"] > 0
                    and (r["permute_bytes"], r["allreduce_bytes"],
                         r["other_collective_bytes"])
                    == (0, want[r["variant"]], 0),
                    f"the card {r['device']!r}, nccl, link unmeasured, "
                    f"permute / all-reduce / all-gather bytes "
                    f"{r['permute_bytes']} / {r['allreduce_bytes']} / "
                    f"{r['other_collective_bytes']}")
        print(f"[timing] {card}: comm_analysis {r['variant']} step, (1, 1), "
              f"C = 1, {r['per_shard_samples']:,} samples a shard: "
              f"t_compute {r['t_compute_s'] * 1e3:.3f} ms (CUDA events, "
              f"digest pulled), result gather {r['result_gather_bytes']:,} "
              f"bytes")
    return launches


def comm_k5(device) -> float:
    """K5 against its plain version at the (1, 1) etsi step's shape: its
    block inside its zero halos from start -halo, C = 1 at the audit's
    0 Hz and at -25 kHz (carrier 0 of the (2, 2) mesh's two)."""
    import torch
    from tetraear_tpu_torch.config import ReceiverConfig
    from tetraear_tpu_torch.ops.kernels import fused_channelize as k5
    from tetraear_tpu_torch.parallel.sharded import _staged_taps
    from tetraear_tpu_torch.tools import comm_analysis as ca
    cfg = ReceiverConfig()
    taps, _ = _staged_taps(cfg, device)
    t_local, halo, x, offsets = ca.step_case("etsi", 1, 1, COMM_SCALE)
    xe = torch.zeros(t_local + 2 * halo, dtype=torch.complex64,
                     device=device)
    xe[halo:halo + t_local] = torch.as_tensor(x, device=device)
    worst = 0.0
    for offs in (offsets, offsets - 25e3):
        offs = torch.as_tensor(offs, device=device)
        got = _launched("fused_channelize", lambda: k5.fused_channelize(
            xe, offs, cfg.sample_rate_hz, cfg.decimation_factor, taps,
            -halo))
        want = k5.fused_channelize_plain(xe, offs, cfg.sample_rate_hz,
                                         cfg.decimation_factor, taps, -halo)
        worst = max(worst, _held(
            f"K5 comm_analysis etsi step C=1 at {float(offs[0]):.0f} Hz "
            f"n={xe.numel()} start={-halo}", "K5", got, want, TOL))
    return worst


def _comm_rank(tmp: str) -> None:
    """A rank of a 4-rank gloo world on the one card: the audit's counts
    of one step on each mesh of COMM_MESHES, on the card and on the CPU,
    written to counts_<rank>.json."""
    import torch.distributed as dist
    from tetraear_tpu_torch.entry import rank_device
    from tetraear_tpu_torch.parallel.mesh import make_mesh
    from tetraear_tpu_torch.tools import comm_analysis as ca
    rank = dist.get_rank()
    counts = {}
    for carrier, time_ in COMM_MESHES:
        t_local, halo, x, offsets = ca.step_case(COMM_STEP, carrier, time_,
                                                 1)
        for device_type in ("cuda", "cpu"):
            mesh = make_mesh(carrier, time_, device_type=device_type)
            run, args = ca.build(mesh, COMM_STEP, halo, x, offsets,
                                 rank_device(device_type, rank))
            counts[f"{carrier}x{time_} {device_type}"] = ca.count_step(
                mesh, run, args)
    (Path(tmp) / f"counts_{rank}.json").write_text(json.dumps(counts))


def comm_four_ranks() -> None:
    """4 ranks on the one card over gloo: each mesh's per-kind bytes,
    calls, sent bytes and result gather on the card equal to the same
    ranks' on the CPU (bytes do not depend on the device)."""
    from tetraear_tpu_torch.entry import launch
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        launch(4, "cuda", _comm_rank, tmp, backend="gloo", timeout=300)
        ranks = [json.loads((Path(tmp) / f"counts_{r}.json").read_text())
                 for r in range(4)]
    for carrier, time_ in COMM_MESHES:
        mesh = f"{carrier}x{time_}"
        card = [c[f"{mesh} cuda"] for c in ranks]
        cpu = [c[f"{mesh} cpu"] for c in ranks]
        print(f"[comm] {COMM_STEP} ({carrier}, {time_}), 4 gloo ranks on the "
              f"card: {json.dumps(card[0]['collective_bytes'])}, calls "
              f"{json.dumps(card[0]['collectives'])}, sent by rank "
              f"{[c['sent_bytes'] for c in card]}, result gather "
              f"{card[0]['result_gather_bytes']:,} B")
        _comm_check(f"{COMM_STEP} ({carrier}, {time_})", card == cpu
                    and card[0]["collective_bytes"]["collective-permute"] > 0,
                    "every rank's counts on the card equal to its counts "
                    "on the CPU")
    print(f"[comm] four-rank world in {time.perf_counter() - t0:.1f} s")


def phase_comm(device, card: str) -> tuple:
    """9: the communication audit (module docstring); returns (launches
    of its path, K5's largest error at the etsi step's shape)."""
    t0 = time.perf_counter()
    launches = comm_world_of_one(card)
    k5_err = comm_k5(device)
    comm_four_ranks()
    print(f"[comm] phase 9 in {time.perf_counter() - t0:.1f} s")
    return launches, k5_err


# --- 10. bench: the wideband bench (tetraear_tpu_torch/bench.py) ----------

BENCH_CARRIERS, BENCH_SCALE, BENCH_ITERS = 16, 8, 6   # the bench's defaults
# tier -> the launch counter of its kernel (None: plain PyTorch)
BENCH_TIER_KERNELS = {
    "fused_pallas_bf16": "s2d_conv_bf16", "pfb": "s2d_conv_bf16",
    "complex": "fused_channelize", "realpair64": None, "single": None,
    "fused_pallas": "s2d_conv", "fused_pallas_db": "s2d_conv_db",
    "fused_pallas_of4_bf16": "s2d_conv_of_bf16"}


def _bench_check(tag: str, cond: bool, msg: str) -> None:
    if not cond:
        fail("bench", f"{tag}: {msg}")


def _bench_line(tag: str, line: str, carriers: int, variant: str) -> dict:
    """The one-line contract of a card run: four keys, the per-chip
    metric of `carriers` (none for the single tier) and `variant`, a
    finite positive rate."""
    import math
    rec = json.loads(line)
    scope = "" if variant.startswith("singlecarrier") else \
        f"{carriers}carrier_"
    _bench_check(tag, set(rec) == {"metric", "value", "unit",
                                   "vs_baseline"}, f"keys {sorted(rec)}")
    _bench_check(tag, rec["metric"] == "iq_samples_per_sec_per_chip_"
                 f"{scope}{variant}", f"metric {rec['metric']}")
    _bench_check(tag, rec["unit"] == "samples/s" and math.isfinite(
        rec["value"]) and rec["value"] > 0, f"value {rec['value']}")
    return rec


def bench_phase6_ms(tier: str, t: dict, single_ms: float) -> str:
    """Phase 6's time for the same frontend (its conv alone where phase 6
    timed no frontend of the tier's conv)."""
    fe = {"fused_pallas_bf16": t["fe16"]["frontend"],
          "pfb": t["pfb_pallas_bf16"]["frontend"], "complex": t["staged"],
          "realpair64": t["realpair64"]}
    if tier in fe:
        return f"phase 6: {fe[tier]:.3f} ms a block"
    if tier == "single":
        return (f"phase 6: {single_ms:.3f} ms a {SC_CHUNK}-sample chunk "
                "(ref-compat Frontend)")
    conv = {"fused_pallas": "k1_f32", "fused_pallas_db": "k3",
            "fused_pallas_of4_bf16": "k1of_bf16"}[tier]
    return f"phase 6: its conv alone {t[conv]['ms']:.3f} ms"


def bench_tiers(device, card: str, t: dict, single_ms: float) -> dict:
    """Each tier of BENCH_TIER_KERNELS through the bench's tier programs
    and rate at the default block, its launch counts set to 0 just before
    and read just after; -> the launches of all of them."""
    import torch
    from tetraear_tpu_torch import bench
    from tetraear_tpu_torch.ops.kernels import launches, reset_launches
    total = dict.fromkeys(launches(), 0)
    n = bench.block_size(BENCH_SCALE)
    for tier, kernel in BENCH_TIER_KERNELS.items():
        reset_launches()
        rate, variant, carriers = bench._run_tier(
            tier, BENCH_CARRIERS, BENCH_SCALE, BENCH_ITERS, device)
        counts = launches()
        steps = (BENCH_ITERS * (4 if tier == "single" else 1)) + 3
        want = {kernel: steps} if kernel else {}
        _bench_check(tier, {k: v for k, v in counts.items() if v} == want,
                     f"launches {counts}, expected {want}")
        _bench_check(tier, rate.n == (2048 * 130 if tier == "single" else n)
                     and carriers == (96 if tier == "pfb" else 1
                                      if tier == "single" else
                                      BENCH_CARRIERS),
                     f"n {rate.n}, carriers {carriers}")
        rec = _bench_line(tier, bench._result_line(
            {"sps": rate.sps, "variant": variant, "carriers": carriers,
             "backend": device.type}), carriers, variant)
        print(f"[bench] {card}: {tier} ({variant}, {carriers} carriers, "
              f"n={rate.n}): {rate.sps:,.0f} samples/s (host clock, "
              f"{rate.step_ms:.3f} ms a step); CUDA events "
              f"{rate.event_step_ms:.3f} ms a step = {rate.event_sps:,.0f} "
              f"samples/s; {bench_phase6_ms(tier, t, single_ms)}; "
              f"{rec['metric']}; launches {want or 'none'}")
        for k, v in counts.items():
            total[k] += v
        torch.cuda.empty_cache()
    return total


def bench_module_run(card: str) -> None:
    """`python -m tetraear_tpu_torch.bench` with the defaults, as a user
    types it, in a process of its own: exactly one JSON line on stdout,
    the faster of the two default goals."""
    import os
    env = {k: v for k, v in os.environ.items() if not k.startswith("BENCH_")}
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "tetraear_tpu_torch.bench"],
                          capture_output=True, text=True, timeout=300,
                          env=env, cwd=Path(__file__).resolve().parent)
    for line in proc.stderr.splitlines():
        if line.startswith("[bench"):
            print(f"[bench]   {line}")
    _bench_check("module", proc.returncode == 0,
                 f"exit {proc.returncode}: {proc.stderr[-2000:]}")
    lines = [line for line in proc.stdout.splitlines() if line.strip()]
    _bench_check("module", len(lines) == 1, f"stdout {proc.stdout!r}")
    rec = json.loads(lines[0])
    want = {"iq_samples_per_sec_per_chip_16carrier_"
            "fused_pallas_bf16_demod_decode": (16, "fused_pallas_bf16_"
                                               "demod_decode"),
            "iq_samples_per_sec_per_chip_96carrier_pfb_demod_decode":
            (96, "pfb_demod_decode")}
    _bench_check("module", rec.get("metric") in want,
                 f"metric {rec.get('metric')}")
    _bench_line("module", lines[0], *want[rec["metric"]])
    print(f"[bench] {card}: python -m tetraear_tpu_torch.bench: {lines[0]} "
          f"({time.perf_counter() - t0:.1f} s)")


def phase_bench(device, card: str, t: dict, single_ms: float) -> dict:
    """10: the wideband bench (module docstring); returns the launches of
    its tiers."""
    t0 = time.perf_counter()
    launches = bench_tiers(device, card, t, single_ms)
    bench_module_run(card)
    print(f"[bench] phase 10 in {time.perf_counter() - t0:.1f} s")
    return launches


def main() -> int:
    card = phase_device()
    import os
    import torch
    # the CLI's per-run log files go to a directory of this run
    log_dir = tempfile.TemporaryDirectory()
    os.environ["TETRAEAR_TPU_LOG_DIR"] = log_dir.name
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
    viterbi = phase_viterbi(device, card)
    errs["viterbi"] = viterbi["max_abs_err"]
    sync_walk = phase_sync_walk(device, card)
    errs["sync_walk"] = sync_walk["max_abs_err"]
    t2 = time.perf_counter()
    launches = phase_decode(device)
    t3 = time.perf_counter()
    for name, n in phase_single(device).items():
        launches[name] += n
    for name, n in phase_downlink(device).items():
        launches[name] += n
    for name, n in phase_operator(device).items():
        launches[name] += n
    t_pod = time.perf_counter()
    pod_launches, k5_pod_err = phase_pod(device, card)
    for name, n in pod_launches.items():
        launches[name] += n
    errs["fused_channelize"] = max(errs["fused_channelize"], k5_pod_err)
    t_tools = time.perf_counter()
    tool_launches, k5_tool_err = phase_tools(device, card)
    for name, n in tool_launches.items():
        launches[name] += n
    errs["fused_channelize"] = max(errs["fused_channelize"], k5_tool_err)
    t_comm = time.perf_counter()
    comm_launches, k5_comm_err = phase_comm(device, card)
    for name, n in comm_launches.items():
        launches[name] += n
    errs["fused_channelize"] = max(errs["fused_channelize"], k5_comm_err)
    t4 = time.perf_counter()
    t = phase_timing(device, card)
    t["viterbi"] = viterbi
    t["sync_walk"] = sync_walk
    t5 = time.perf_counter()
    single_ms = phase_timing_single(device, card)
    t6 = time.perf_counter()
    phase_timing_downlink(device, card)
    t7 = time.perf_counter()
    phase_timing_operator(device, card)
    t8 = time.perf_counter()
    for name, n in phase_bench(device, card, t, single_ms).items():
        launches[name] += n
    print(f"[timing] phases: build {t1 - t0:.1f} s, kernel + viterbi + sync "
          f"{t2 - t1:.1f} s, "
          f"decode {t3 - t2:.1f} s, single + downlink + operator "
          f"{t_pod - t3:.1f} s, pod {t_tools - t_pod:.1f} s, tools "
          f"{t_comm - t_tools:.1f} s, comm {t4 - t_comm:.1f} s, timing "
          f"{t5 - t4:.1f} s, single timing "
          f"{t6 - t5:.1f} s, downlink timing {t7 - t6:.1f} s, operator "
          f"timing {t8 - t7:.1f} s, bench "
          f"{time.perf_counter() - t8:.1f} s")
    times = {"s2d_conv": "k1_f32", "s2d_conv_bf16": "k1_bf16",
             "s2d_conv_of": "k1of_f32", "s2d_conv_of_bf16": "k1of_bf16",
             "s2d_conv_db": "k3", "s2d_conv_dt": "k4_f32",
             "s2d_conv_dt_bf16": "k4_bf16", "fused_channelize": "k5",
             "viterbi": "viterbi", "sync_walk": "sync_walk"}
    print(card)
    print(json.dumps({"kernels": [{
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": launches[name],
        "max_abs_err": errs[name],
        "ms": t[times[name]]["ms"],
        "plain_ms": t[times[name]]["plain_ms"],
        "bound_ms": t[times[name]]["bound_ms"],
        "bound_by": t[times[name]]["bound_by"],
        "library_ms": t[times[name]]["library_ms"],
    } for name, (source, replaces) in KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
