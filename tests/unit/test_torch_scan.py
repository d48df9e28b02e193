"""The port's scanner (`signal/detector.py`, `signal/scanner.py`) and its
`scan` command against the JAX package's, on the CPU.

Inputs are made with numpy from fixed seeds: a planted TETRA signal and
noise for the detector, the synthetic source for the stepped scan, and
for the wideband sweep one capture of 1 << 20 samples (the sweep's own
size) with texts on three 25 kHz channels (`utils.synth.planted_scan`).
Decisions must be identical (is_tetra, signal_present, sync_detected,
frames_validated, power_stable, crc_pass_rate); floats within 1e-4
relative, channel powers within 1e-3 dB (spectra in f32; FFTs in another
order).  A fault of the device must end a scan; a host decode error stays
caught, as in the reference."""

import re

import jax
import numpy as np
import pytest

from tetraear_tpu.io import replay as jreplay
from tetraear_tpu.signal.detector import TetraSignalDetector as JaxDetector
from tetraear_tpu.signal.scanner import FrequencyScanner as JaxScanner
from tetraear_tpu.ui import cli as jax_cli

from tetraear_tpu_torch.io import replay as treplay
from tetraear_tpu_torch.models import multicarrier as tmc
from tetraear_tpu_torch.models.receiver import SignalProcessor
from tetraear_tpu_torch.signal.detector import TetraSignalDetector
from tetraear_tpu_torch.signal.scanner import FrequencyScanner
from tetraear_tpu_torch.ui import cli
from tetraear_tpu_torch.utils import synth as tsynth

REL_TOL = 1e-4
DB_TOL = 1e-3
CENTER = 392.5e6
DECISIONS = ("is_tetra", "signal_present", "sync_detected",
             "frames_validated", "power_stable", "crc_pass_rate",
             "frequency", "frequency_mhz", "error")


@pytest.fixture(autouse=True)
def _log_dir(tmp_path, monkeypatch):
    """Both CLIs write their per-run logs to TETRAEAR_TPU_LOG_DIR; the
    JAX package's CLI also turns on jax's persistent compilation cache
    under $HOME: both go to a temporary directory, and the cache is off
    again after each test."""
    from jax._src import compilation_cache
    monkeypatch.setenv("TETRAEAR_TPU_LOG_DIR", str(tmp_path / "logs"))
    monkeypatch.setenv("HOME", str(tmp_path))
    saved = (jax.config.jax_compilation_cache_dir,
             jax.config.jax_persistent_cache_min_compile_time_secs)
    yield
    jax.config.update("jax_compilation_cache_dir", saved[0])
    jax.config.update("jax_persistent_cache_min_compile_time_secs", saved[1])
    compilation_cache.reset_cache()


@pytest.fixture(scope="module")
def scan_iq(tmp_path_factory):
    x, want = tsynth.planted_scan()
    path = tmp_path_factory.mktemp("iq") / "scan.cf32"
    treplay.save_iq(path, x, sample_rate=2.4e6, center_frequency=CENTER)
    return path, want


def _same_result(mine: dict, ref: dict) -> None:
    """Decisions equal, floats within REL_TOL, power_db within DB_TOL."""
    assert mine.keys() == ref.keys()
    for key, want in ref.items():
        got = mine[key]
        if key in DECISIONS or isinstance(want, (bool, np.bool_)):
            assert got == want, (key, got, want)
        elif key == "power_db":
            assert abs(got - want) <= DB_TOL, (key, got, want)
        else:
            assert got == pytest.approx(want, rel=REL_TOL, abs=1e-12), key


@pytest.mark.parametrize("signal", ["planted", "noise"])
def test_analyze_signal_equals_the_reference(signal):
    """TetraSignalDetector.analyze_signal on a planted TETRA signal (the
    frame validation decodes it) and on noise: every decision equal."""
    if signal == "planted":
        rng = np.random.default_rng(7)
        x, _ = tsynth.planted_single("ref-compat", num_frames=6)
        x = x + 0.05 * (rng.standard_normal(len(x))
                        + 1j * rng.standard_normal(len(x)))
    else:   # tests/integration/test_end_to_end.py:125's noise
        rng = np.random.default_rng(1)
        x = 0.001 * (rng.standard_normal(100_000)
                     + 1j * rng.standard_normal(100_000))
    x = x.astype(np.complex64)
    mine = TetraSignalDetector(device="cpu").analyze_signal(x)
    ref = JaxDetector().analyze_signal(x)
    _same_result(mine, ref)
    assert mine["is_tetra"] == (signal == "planted")
    assert mine["frames_validated"] == (signal == "planted")


def test_scan_frequency_and_range_on_the_synthetic_source():
    """scan_frequency on and off the synthetic source's carrier and
    scan_range across it: the reference's results."""
    results = []
    for scanner_cls, replay, kw in ((FrequencyScanner, treplay,
                                     {"device": "cpu"}),
                                    (JaxScanner, jreplay, {})):
        src = replay.SyntheticSource(active_frequencies=(392.5e6,),
                                     snr_db=25, frequency=392.5e6)
        src.open()
        sc = scanner_cls(src, settle_s=0.0, **kw)
        hot = sc.scan_frequency(392.5e6, dwell_time=0.05)
        cold = sc.scan_frequency(391.0e6, dwell_time=0.05)
        found = sc.scan_range(392.45e6, 392.55e6)
        results.append((hot, cold, found))
    (hot, cold, found), (rhot, rcold, rfound) = results
    _same_result(hot, rhot)
    _same_result(cold, rcold)
    assert hot["power_db"] > cold["power_db"] + 10
    assert len(found) == len(rfound)
    for a, b in zip(found, rfound):
        _same_result(a, b)


@pytest.mark.parametrize("validate", [True, False])
def test_scan_wideband_equals_the_reference(scan_iq, validate):
    """scan_wideband over one 1 << 20-sample capture: the channel powers
    within 1e-3 dB and, validated through the staged multicarrier decode
    on the hot channels, the same decisions; each planted channel is
    TETRA, and nothing else is."""
    path, want = scan_iq
    out = []
    for scanner_cls, replay, kw in ((FrequencyScanner, treplay,
                                     {"device": "cpu"}),
                                    (JaxScanner, jreplay, {})):
        src = replay.FileReplaySource(path, frequency=CENTER)
        src.open()
        out.append(scanner_cls(src, settle_s=0.0, **kw).scan_wideband(
            CENTER, validate=validate))
    mine, ref = out
    assert len(mine) == len(ref) == 95
    for a, b in zip(mine, ref):
        _same_result(a, b)
    tetra = {r["frequency"] - CENTER for r in mine if r["is_tetra"]}
    assert tetra == (set(want) if validate else set())
    hot = [r for r in mine if r["power_db"] > -70]
    assert len(hot) >= len(want)


def _result_lines(lines) -> list:
    return [line for line in lines if re.match(r"\s+\d+\.\d{3} MHz: ", line)
            or line.startswith(("Wideband", "Scanning", "[OK]", "[X]"))]


@pytest.mark.parametrize("mode", ["wideband", "stepped"])
def test_scan_cli_equals_jax_cli(scan_iq, capsys, mode):
    """`scan START STOP --iq-file f -f CENTER [--wideband]`: the JAX CLI's
    result lines (the top 20 channels with their TETRA flags; stepped,
    five channels around the centre and the best signal)."""
    path, want = scan_iq
    span = ["391.4", "393.6"] if mode == "wideband" else ["392.45", "392.55"]
    argv = ["scan", *span, "--iq-file", str(path), "-f", "392.5"]
    if mode == "wideband":
        argv.append("--wideband")
    assert cli.main([*argv, "--device", "cpu"]) == 0
    mine = capsys.readouterr().out.splitlines()
    assert jax_cli.main(argv) == 0
    theirs = capsys.readouterr().out.splitlines()
    assert _result_lines(mine) == _result_lines(theirs)
    tagged = [line for line in mine if line.endswith("*** TETRA")]
    if mode == "wideband":
        assert len(_result_lines(mine)) == 21
        assert sorted(float(line.split()[0]) for line in tagged) == sorted(
            round((CENTER + off) / 1e6, 3) for off in want)
    else:
        # the replay does not retune: each probe reads the next 262,144
        # samples, whose centre channel carries a text; the fifth reads
        # the capture's short tail
        assert len(tagged) == 4


# --- device faults -----------------------------------------------------------

def _raise_cuda(*_args, **_kw):
    raise RuntimeError("CUDA error: an illegal memory access was "
                       "encountered")


def test_scan_frequency_ends_on_a_device_fault(monkeypatch):
    """The detector's processor raising (a failed launch) ends the probe
    with the exception; the reference would report -100 dB."""
    monkeypatch.setattr(SignalProcessor, "process", _raise_cuda)
    src = treplay.SyntheticSource(active_frequencies=(392.5e6,), snr_db=25,
                                  frequency=392.5e6)
    sc = FrequencyScanner(src, settle_s=0.0, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA error"):
        sc.scan_frequency(392.5e6, dwell_time=0.05)


def test_retune_and_host_decode_errors_stay_caught(monkeypatch):
    """A retune that fails is the reference's -100 dB result with the
    error, and a host decode error is the detector's "not validated"."""
    from tetraear_tpu_torch.core.decoder import TetraDecoder

    class Broken(treplay.SyntheticSource):
        def set_frequency(self, frequency):
            raise OSError("tuner unplugged")
    sc = FrequencyScanner(Broken(), settle_s=0.0, device="cpu")
    res = sc.scan_frequency(392.5e6, dwell_time=0.05)
    assert res["power_db"] == -100 and res["error"] == "tuner unplugged"

    def bad(self, scored):
        raise ValueError("malformed burst")
    monkeypatch.setattr(TetraDecoder, "decode_scored", bad)
    x, _ = tsynth.planted_single("ref-compat", num_frames=6)
    assert TetraSignalDetector(device="cpu").validate_frames(x) == (False,
                                                                    0.0)


@pytest.mark.parametrize("mode", ["wideband", "stepped"])
def test_scan_cli_exits_nonzero_on_a_device_fault(scan_iq, monkeypatch,
                                                  mode):
    """`scan` ends with the exception when the device fails: in the
    stepped scan the detector's processor, in the wideband sweep the
    staged frontend's channelizer."""
    path, _ = scan_iq
    if mode == "wideband":
        monkeypatch.setattr(tmc.StagedMulticarrierFrontend, "channelize",
                            _raise_cuda)
        argv = ["scan", "391.4", "393.6", "--wideband"]
    else:
        monkeypatch.setattr(SignalProcessor, "process", _raise_cuda)
        argv = ["scan", "392.45", "392.55"]
    with pytest.raises(RuntimeError, match="CUDA error"):
        cli.main([*argv, "--iq-file", str(path), "-f", "392.5",
                  "--device", "cpu"])


# --- on the card -------------------------------------------------------------

@pytest.fixture
def cuda_device():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda:0")


def _sweep_offsets() -> np.ndarray:
    """Every channel one 2.4 MS/s sweep around CENTER covers: 95."""
    half = 2.4e6 / 2 - 25e3
    k = np.arange(int(np.ceil((CENTER - half) / 25e3)),
                  int((CENTER + half) // 25e3) + 1)
    return (k * 25e3 - CENTER).astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("count", [1, 3, 95])
def test_k5_at_the_sweeps_carrier_counts(cuda_device, count):
    """K5 at the carrier counts scan_wideband gives it (one hot channel,
    three, every channel of the sweep) on the sweep's offsets and its
    1,044,480 validated samples: within 4e-6 x max of its plain version."""
    import torch
    from tetraear_tpu_torch.config import ReceiverConfig
    from tetraear_tpu_torch.models.realpair import staged_state
    from tetraear_tpu_torch.ops.kernels import fused_channelize as k5
    offsets = {1: np.array([-300e3], np.float32),
               3: np.array([-300e3, 0.0, 475e3], np.float32),
               95: _sweep_offsets()}[count]
    state = staged_state(offsets, ReceiverConfig())
    offs = torch.as_tensor(state.offsets_hz, device=cuda_device)
    taps = torch.as_tensor(state.taps_d, device=cuda_device)
    r = np.random.default_rng(count)
    x = torch.as_tensor((r.standard_normal(1_044_480)
                         + 1j * r.standard_normal(1_044_480)
                         ).astype(np.complex64) * 0.1, device=cuda_device)
    got = k5.fused_channelize(x, offs, state.sample_rate_hz, state.decim,
                              taps)
    want = k5.fused_channelize_plain(x, offs, state.sample_rate_hz,
                                     state.decim, taps)
    assert got.shape == want.shape == (count, 104_448)
    assert ((got - want).abs().max() <= 4e-6 * want.abs().max()).item()


@pytest.mark.cuda
def test_scan_wideband_on_card_equals_cpu(cuda_device, scan_iq):
    """scan_wideband on the card (K5 validating the hot channels) makes
    the CPU run's decisions, powers within 1e-3 dB."""
    from tetraear_tpu_torch.ops.kernels import launches
    path, want = scan_iq
    out = []
    for dev in (cuda_device, "cpu"):
        src = treplay.FileReplaySource(path, frequency=CENTER)
        src.open()
        before = launches()["fused_channelize"]
        out.append(FrequencyScanner(src, settle_s=0.0, device=dev)
                   .scan_wideband(CENTER))
        if dev != "cpu":
            assert launches()["fused_channelize"] == before + 1
    for a, b in zip(*out):
        _same_result(a, b)
    assert {r["frequency"] - CENTER for r in out[0]
            if r["is_tetra"]} == set(want)
