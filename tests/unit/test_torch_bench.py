"""The port's wideband bench (tetraear_tpu_torch/bench.py) against the JAX
bench (bench.py), on the CPU.

Parity: for each ported tier at 4 carriers and scale 1 (1,039,968
samples; the single tier 266,240), the JAX bench's own `_run_tier` runs
with `_verified_rate` replaced on the imported module by one that keeps
`step_fn(inputs[0])` and returns the digest (bench.py is not edited),
and the port's `tier_program` runs on the same seeded input with
--device cpu, where every kernel wrapper runs its plain version.  Held:
- the valid symbol counts equal;
- the digest within DIGEST_RTOL = 1e-5 relative: it sums ~10^6 f32
  sync scores (10^7 on the 96-channel tier), whose sum order differs
  between XLA and PyTorch, and flipped noise bits move it by a few
  1/22 steps (the staged tier: 2.7e-6 measured);
- bits >= 99.5 % equal and the sync scores within 1e-4 wherever their
  22-bit window agrees (test_torch_tools.py's `_hold_ref` noise rule:
  a noise symbol near zero flips under another f32 sum order, as on the
  staged tier, 99.98 % equal); where a carrier's bits all agree, its
  candidates (valid mask, positions, frames, CRC verdicts) equal;
- the bf16 tier against JAX's bf16 tier (interpret-mode Pallas, bf16
  operands, f32 accumulation) under the same rules: both round the same
  operands to bf16, so only the f32 sum order differs (bit-equal here).

Then the contract of tests/unit/test_bench.py: the result line, the
watchdog, unknown tiers, BENCH_PFB_VARIANT, --device cuda without a
card, one JSON line from `python -m tetraear_tpu_torch.bench`, and no
tier standing in for one that failed."""

import importlib.util
import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from tetraear_tpu_torch import bench as tbench
from tetraear_tpu_torch.ops import kernels

REPO = Path(__file__).resolve().parents[2]
CARRIERS, SCALE = 4, 1
DIGEST_RTOL = 1e-5
SIGNALS = (signal.SIGTERM, signal.SIGINT, signal.SIGHUP)
PARITY_TIERS = ("complex", "fused_pallas_bf16", "fused_s2d", "fused_s2d_of",
                "pfb", "realpair64", "realpair0", "single")


def _jax_bench():
    """bench.py as a module of its own name, so that replacing its
    `_verified_rate` touches no other importer of bench.py."""
    spec = importlib.util.spec_from_file_location("jax_bench_for_parity",
                                                  REPO / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_tier():
    """tier -> (numpy result fields, digest, variant, carriers) of the
    JAX bench's `_run_tier` on its CPU backend (pfb: the gather form)."""
    jb = _jax_bench()
    kept = {}

    def keep(step_fn, digest_fn, inputs, n, iters):
        out = step_fn(inputs[0])
        kept["out"] = out
        return float(digest_fn(out))

    jb._verified_rate = keep
    cache = {}

    def run(tier):
        if tier not in cache:
            digest, variant, carriers = jb._run_tier(tier, CARRIERS, SCALE, 1)
            out = kept.pop("out")
            fields = {k: np.asarray(v) for k, v in out._asdict().items()}
            cache[tier] = (fields, digest, variant, carriers)
        return cache[tier]
    return run


def _port_tier(tier):
    prog = tbench.tier_program(tier, CARRIERS, SCALE, "cpu")
    out = prog.step(prog.inputs[0])
    fields = {k: v.numpy() for k, v in out._asdict().items()}
    return prog, fields, float(prog.digest(out))


@pytest.mark.parametrize("tier", PARITY_TIERS)
def test_tier_holds_the_jax_bench(jax_tier, tier):
    want, want_digest, variant, carriers = jax_tier(tier)
    prog, got, digest = _port_tier(tier)
    assert (prog.variant, prog.carriers) == (variant, carriers)
    assert prog.variant == tbench.TIERS[tier]
    np.testing.assert_array_equal(got["count"], want["count"])
    assert abs(digest - want_digest) <= DIGEST_RTOL * abs(want_digest)
    bits, want_bits = got["bits"], want["bits"]
    assert bits.shape == want_bits.shape
    same = bits == want_bits
    assert same.mean() >= 0.995, same.mean()
    window = np.lib.stride_tricks.sliding_window_view(same, 22, axis=-1)
    agree = window.all(axis=-1)
    assert agree.mean() >= 0.99
    np.testing.assert_allclose(got["sync_corr"][agree],
                               want["sync_corr"][agree], atol=1e-4)
    if "cand_valid" in want:
        rows = np.flatnonzero(same.reshape(same.shape[0], -1).all(axis=-1))
        assert len(rows) >= 1 or tier == "complex"
        for field in ("cand_valid", "cand_pos", "frame_bits", "crc_ok"):
            np.testing.assert_array_equal(got[field][rows],
                                          want[field][rows], err_msg=field)


def test_block_and_inputs_are_the_jax_benchs():
    assert tbench.block_size(8) == 8_319_936
    assert tbench.block_size(1) == 1_039_968
    offsets, xs = tbench.block_inputs(16, 960)
    np.testing.assert_array_equal(offsets, (np.arange(16) - 8) * 25e3)
    rng = np.random.default_rng(0)
    for x in xs:
        want = (rng.standard_normal(960) + 1j * rng.standard_normal(960)
                ).astype(np.complex64) * 0.1
        assert x.dtype == np.complex64
        np.testing.assert_array_equal(x, want)


@pytest.mark.parametrize("tier,kernel", [
    ("fused_pallas_bf16", "s2d_conv_bf16"), ("fused_pallas", "s2d_conv"),
    ("fused_pallas_db", "s2d_conv_db"), ("fused_pallas_of4", "s2d_conv_of"),
    ("fused_pallas_of4_bf16", "s2d_conv_of_bf16"),
    ("complex", "fused_channelize"), ("fused_s2d", None), ("fused", None)])
def test_tier_names_its_kernel(tier, kernel):
    """Each tier's launch counter, and a source of ops.kernels for it."""
    prog = tbench.tier_program(tier, 2, SCALE, "cpu")
    assert prog.kernel == kernel
    if kernel is not None:
        assert kernel in kernels.launches()
        assert tbench.KERNEL_SOURCES[kernel] in kernels.SOURCES


def test_pfb_tier_names_its_variant_kernel(monkeypatch):
    """Off the CPU the pfb tier runs BENCH_PFB_VARIANT (built here on the
    meta device, which runs nothing); on the CPU the gather form."""
    assert tbench.tier_program("pfb", 2, SCALE, "cpu").kernel is None
    for variant, kernel in (("pallas_bf16", "s2d_conv_bf16"),
                            ("pallas", "s2d_conv"),
                            ("pallas_db", "s2d_conv_db"), ("s2d", None)):
        monkeypatch.setenv("BENCH_PFB_VARIANT", variant)
        prog = tbench.tier_program("pfb", 2, SCALE, "meta")
        assert (prog.kernel, prog.carriers) == (kernel, 96)
    monkeypatch.delenv("BENCH_PFB_VARIANT")
    assert tbench.tier_program("pfb", 2, SCALE, "meta").kernel == \
        "s2d_conv_bf16"


# --- the contract ------------------------------------------------------------

def test_result_line_card_cpu_and_none():
    card = json.loads(tbench._result_line(
        {"sps": 2.4e9, "variant": "fused_pallas_bf16_demod_decode",
         "carriers": 16, "backend": "cuda"}))
    assert card == {"metric": "iq_samples_per_sec_per_chip_16carrier_"
                              "fused_pallas_bf16_demod_decode",
                    "value": 2.4e9, "unit": "samples/s",
                    "vs_baseline": 1000.0}
    pfb = json.loads(tbench._result_line(
        {"sps": 1.5e9, "variant": "pfb_demod_decode", "carriers": 96,
         "backend": "cuda"}))
    assert pfb["metric"] == "iq_samples_per_sec_per_chip_96carrier_" \
                            "pfb_demod_decode"
    single = json.loads(tbench._result_line(
        {"sps": 1e8, "variant": "singlecarrier_demod_sync", "carriers": 1,
         "backend": "cuda"}))
    assert single["metric"] == ("iq_samples_per_sec_per_chip_"
                                "singlecarrier_demod_sync")
    cpu = json.loads(tbench._result_line(
        {"sps": 4.6e6, "variant": "demod_decode", "carriers": 4,
         "backend": "cpu"}))
    assert cpu["metric"] == "iq_samples_per_sec_4carrier_demod_decode_" \
                            "cpu_fallback"
    failed = json.loads(tbench._result_line(None))
    assert failed == {"metric": "bench_failed", "value": 0,
                      "unit": "samples/s", "vs_baseline": 0}


def test_verified_rate_raises_on_hang(monkeypatch):
    """A digest whose pull never completes raises, not wedges the bench."""
    monkeypatch.setattr(tbench, "FIRST_SYNC_S", 0.2)
    monkeypatch.setattr(tbench, "WATCHDOG_S", 0.2)

    class Hung:
        def __float__(self):
            time.sleep(3600)

    with pytest.raises(TimeoutError):
        tbench._verified_rate(lambda x: x, lambda out: Hung(),
                              [np.zeros(4)], 4, 1)


def test_verified_rate_runs_warmup_base_and_full():
    """One warm-up step, t(1), then t(iters + 1) over alternating
    inputs; the rate is n x iters over their difference."""
    seen = []

    def step(x):
        seen.append(int(x[0]))
        return torch.zeros(())

    rate = tbench._verified_rate(step, lambda out: out,
                                 [np.zeros(1), np.ones(1)], 1000, 3)
    assert seen == [0, 0, 0, 1, 0, 1]
    assert rate.event_step_ms is None and rate.event_sps is None
    assert rate.n == 1000
    np.testing.assert_allclose(rate.sps * rate.step_ms / 1e3, 1000)


def test_unknown_tier_raises():
    with pytest.raises(ValueError, match="unknown tier"):
        tbench.tier_program("fused_s2d_b4", CARRIERS, SCALE, "cpu")
    with pytest.raises(ValueError):
        tbench.tier_program("fused_pallas_hb16", CARRIERS, SCALE, "cpu")


def test_invalid_pfb_variant_exits(monkeypatch):
    monkeypatch.setenv("BENCH_PFB_VARIANT", "s2d_mono")
    with pytest.raises(SystemExit, match="BENCH_PFB_VARIANT='s2d_mono' "
                                         "invalid"):
        tbench.tier_program("pfb", CARRIERS, SCALE, "cpu")


def test_invalid_pfb_variant_fails_the_run(monkeypatch, capsys):
    monkeypatch.setenv("BENCH_PFB_VARIANT", "pallas_hb16")
    with pytest.raises(SystemExit, match="invalid"):
        tbench.main(["--device", "cpu", "--tier", "pfb"])
    assert json.loads(capsys.readouterr().out)["metric"] == "bench_failed"


def test_cuda_without_a_card_exits_naming_cpu(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        tbench.main([])
    assert "--device cpu" in str(e.value.code)
    lines = capsys.readouterr().out.splitlines()
    assert [json.loads(line)["metric"] for line in lines] == ["bench_failed"]


def test_default_goals_print_the_faster(monkeypatch, capsys):
    """No --tier and no BENCH_TIERS: fused_pallas_bf16, then pfb, and
    the faster one's line; the signal net is taken down on return."""
    monkeypatch.delenv("BENCH_TIERS", raising=False)
    ran = []

    def fake(tier, num_carriers, scale, iters, device):
        ran.append((tier, num_carriers, scale, iters, device.type))
        sps = {"fused_pallas_bf16": 3e9, "pfb": 1.5e9}[tier]
        return (tbench.Rate(sps, 960, 1.0, None), tbench.TIERS[tier],
                96 if tier == "pfb" else num_carriers)

    monkeypatch.setattr(tbench, "_run_tier", fake)
    handlers = [signal.getsignal(s) for s in SIGNALS]
    assert tbench.main(["--device", "cpu"]) == 0
    assert [signal.getsignal(s) for s in SIGNALS] == handlers
    assert ran == [("fused_pallas_bf16", 16, 8, 6, "cpu"),
                   ("pfb", 16, 8, 6, "cpu")]
    line = json.loads(capsys.readouterr().out)
    assert line["metric"] == ("iq_samples_per_sec_16carrier_"
                              "fused_pallas_bf16_demod_decode_cpu_fallback")


def test_failed_tier_ends_the_run_with_no_stand_in(monkeypatch, capsys):
    """BENCH_TIERS runs each listed tier in order; one that raises ends
    the run nonzero with the bench_failed line, whatever ran before."""
    monkeypatch.setenv("BENCH_TIERS", "single, nope")
    for knob, value in (("BENCH_CARRIERS", "2"), ("BENCH_SCALE", "1"),
                        ("BENCH_ITERS", "1")):
        monkeypatch.setenv(knob, value)
    assert tbench.main(["--device", "cpu"]) == 1
    out = capsys.readouterr()
    assert [json.loads(line) for line in out.out.splitlines()] == [
        json.loads(tbench._result_line(None))]
    assert "tier single:" in out.err and "unknown tier nope" in out.err


def test_module_prints_one_json_line(tmp_path):
    env = dict(os.environ, BENCH_CARRIERS="4", BENCH_SCALE="1",
               BENCH_ITERS="1", PYTHONPATH=str(REPO))
    env.pop("BENCH_TIERS", None)
    proc = subprocess.run(
        [sys.executable, "-m", "tetraear_tpu_torch.bench", "--device", "cpu",
         "--tier", "complex"], capture_output=True, text=True, timeout=120,
        env=env, cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = [line for line in proc.stdout.splitlines() if line.strip()]
    assert len(lines) == 1, proc.stdout
    rec = json.loads(lines[0])
    assert set(rec) == {"metric", "value", "unit", "vs_baseline"}
    assert rec["metric"] == "iq_samples_per_sec_4carrier_demod_decode_" \
                            "cpu_fallback"
    assert rec["value"] > 0 and rec["unit"] == "samples/s"
    assert "tier complex:" in proc.stderr


@pytest.mark.cuda
def test_tier_on_card_launches_its_kernel():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    kernels.reset_launches()
    rate, variant, carriers = tbench._run_tier("fused_pallas_bf16", 4,
                                               SCALE, 2, torch.device("cuda"))
    assert kernels.launches()["s2d_conv_bf16"] == 1 + 1 + (2 + 1)
    assert variant == "fused_pallas_bf16_demod_decode" and carriers == 4
    assert rate.sps > 0 and rate.event_step_ms > 0
