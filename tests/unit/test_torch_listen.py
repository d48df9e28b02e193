"""The port's receive loop (`ui/capture_loop.CaptureLoop`) and its
`listen` command against the JAX package's, on the CPU.

The same replay captures (golden slots made with numpy from fixed seeds)
go through both loops at the users' chunk of 131,072 samples: the frames
must be equal field for field, with and without chunk overlap (dedup)
and after a retune, and `listen -o` must write the JAX CLI's JSONL byte
for byte (no field of a frame carries wall-clock time; the printed frame
lines do, and are compared with their [HH:MM:SS.mmm] stamp cut).  A
fault of the device (a processor that raises) must end the loop and the
command; a host decode error stays caught, as in the reference."""

import json
import re

import jax
import numpy as np
import pytest
import torch

from tetraear_tpu.io import recorder as jrec
from tetraear_tpu.io import replay as jreplay
from tetraear_tpu.ui import cli as jax_cli
from tetraear_tpu.ui.capture_loop import CaptureLoop as JaxLoop

from tetraear_tpu_torch.io import recorder as trec
from tetraear_tpu_torch.io import replay as treplay
from tetraear_tpu_torch.models.receiver import SignalProcessor
from tetraear_tpu_torch.ui import cli
from tetraear_tpu_torch.ui.capture_loop import CaptureLoop
from tetraear_tpu_torch.utils import synth as tsynth
from tetraear_tpu_torch.utils.metrics import ThroughputMeter

CHUNK = 128 * 1024            # CaptureLoop's default, capture_loop.py:38


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
def golden_iq(tmp_path_factory):
    """12 golden MAC-RESOURCE slots ("[TXT] HELLO HELLO") on the
    130-sample symbol grid, ~3 chunks of the loop."""
    x, _ = tsynth.planted_single("ref-compat", num_frames=12)
    path = tmp_path_factory.mktemp("iq") / "golden.cf32"
    treplay.save_iq(path, x, sample_rate=2.4e6, center_frequency=392.5e6)
    return path


def _dump(frames, rec) -> list:
    return [json.dumps(rec.sanitize_frame(f), sort_keys=True) for f in frames]


def _run(cls, path, max_chunks=None, retune=None, **kw) -> tuple:
    src = (treplay if cls is CaptureLoop else jreplay).FileReplaySource(path)
    loop = cls(src, sample_rate=2.4e6, auto_decrypt=False,
               always_decode=True, **kw)
    frames = []
    loop.on_frame = frames.append
    if retune is not None:
        loop.set_frequency(retune)
    loop.run(max_chunks=max_chunks)
    return loop, src, frames


@pytest.mark.parametrize("case", ["plain", "overlap", "afc"])
def test_capture_loop_frames_equal_the_reference(golden_iq, case):
    """Every chunk of the replay: the same frames, key for key, as the
    JAX package's CaptureLoop (AFC off for the centred replay, on in
    "afc", where the peak bin of the held symbols is not the carrier and
    the loop derotates by it, as the reference's does: few frames, the
    same ones; "overlap" re-presents 20,000 samples a chunk and drops
    the re-decoded frames by their bits)."""
    kw = {"afc": case == "afc",
          "overlap": 20_000 if case == "overlap" else 0}
    mine, _, a = _run(CaptureLoop, golden_iq, device="cpu", **kw)
    ref, _, b = _run(JaxLoop, golden_iq, **kw)
    assert mine.chunks_processed == ref.chunks_processed >= 3
    assert len(a) == len(b) >= (1 if case == "afc" else 6)
    assert _dump(a, trec) == _dump(b, jrec)
    assert mine.frames_decoded == ref.frames_decoded
    if case != "afc":
        assert {f.get("sds_message") for f in a} == {"[TXT] HELLO HELLO"}
    if case == "overlap":
        plain = _run(CaptureLoop, golden_iq, device="cpu", afc=False)[2]
        assert len(a) >= len(plain)


def test_retune_applied_like_the_reference(golden_iq):
    """set_frequency before the run retunes the source and the loop, as
    the JAX package's does (tests/integration/test_end_to_end.py:105),
    and the frames stay the reference's."""
    mine, msrc, a = _run(CaptureLoop, golden_iq, max_chunks=2,
                         retune=393e6, device="cpu")
    ref, rsrc, b = _run(JaxLoop, golden_iq, max_chunks=2, retune=393e6)
    assert mine.frequency == ref.frequency == 393e6
    assert msrc.frequency == rsrc.frequency == 393e6
    assert _dump(a, trec) == _dump(b, jrec)


def _stamp_cut(lines) -> list:
    return [re.sub(r"^\[\d\d:\d\d:\d\d\.\d\d\d\] ", "[T] ", line)
            for line in lines]


def test_listen_jsonl_equals_jax_cli(golden_iq, tmp_path, capsys):
    """`listen --iq-file f --no-afc --max-chunks 3 -o out.jsonl
    --no-auto-decrypt`: the JAX CLI's JSONL byte for byte, and its frame,
    status and session lines (frame lines with their time stamp cut; the
    meter's line carries host timings and is left out, as is the status
    line that the reference prints before its first chunk)."""
    argv = ["listen", "--iq-file", str(golden_iq), "--no-afc",
            "--max-chunks", "3", "--no-auto-decrypt"]
    out, ref = tmp_path / "port.jsonl", tmp_path / "jax.jsonl"
    assert cli.main([*argv, "--device", "cpu", "-o", str(out)]) == 0
    mine = capsys.readouterr().out.splitlines()
    assert jax_cli.main([*argv, "-o", str(ref)]) == 0
    theirs = capsys.readouterr().out.splitlines()
    assert out.read_bytes() == ref.read_bytes()
    assert len(out.read_text().splitlines()) >= 6
    assert "[DEVICE] cpu (host), listen" in mine

    def keep(lines):
        # the console's log records (time, package name) are not output
        return [line for line in _stamp_cut(lines)
                if not line.startswith(("[DEVICE]", "[STATUS] Started"))
                and not re.match(r"\d{4}-\d\d-\d\d ", line)
                and "samples," not in line]
    assert keep(mine) == keep(theirs)


def test_listen_synthetic_writes_the_waterfall(tmp_path, capsys):
    """`listen --synthetic --max-chunks 4 --waterfall wf.ppm` exits 0 and
    writes the reference's image: same size, and the same pixels as the
    JAX CLI's within one level of a colour channel (the spectra agree
    within f32 rounding; a pixel on a colormap step may round apart)."""
    mine_ppm, ref_ppm = tmp_path / "port.ppm", tmp_path / "jax.ppm"
    argv = ["listen", "--synthetic", "-f", "392.5", "--max-chunks", "4",
            "--no-auto-decrypt"]
    assert cli.main([*argv, "--device", "cpu", "--waterfall",
                     str(mine_ppm)]) == 0
    mine = capsys.readouterr().out
    assert jax_cli.main([*argv, "--waterfall", str(ref_ppm)]) == 0
    capsys.readouterr()
    assert f"Waterfall image: {mine_ppm}" in mine
    a, b = mine_ppm.read_bytes(), ref_ppm.read_bytes()
    head = b"P6\n2048 4\n255\n"
    assert a.startswith(head) and b.startswith(head)
    pa = np.frombuffer(a[len(head):], np.uint8).astype(int)
    pb = np.frombuffer(b[len(head):], np.uint8).astype(int)
    assert pa.shape == pb.shape == (4 * 2048 * 3,)
    assert np.abs(pa - pb).max() <= 1


# --- device faults -----------------------------------------------------------

def _raise_cuda(*_args, **_kw):
    raise RuntimeError("CUDA error: an illegal memory access was "
                       "encountered")


def test_device_fault_ends_the_loop(golden_iq, monkeypatch):
    """A processor that raises (as a failed launch does): the loop
    reports "Fatal error" through on_error, closes its source and
    re-raises; the reference would log it at DEBUG and go on."""
    monkeypatch.setattr(SignalProcessor, "process", _raise_cuda)
    src = treplay.FileReplaySource(golden_iq)
    loop = CaptureLoop(src, always_decode=True, afc=False, device="cpu")
    errors, status = [], []
    loop.on_error, loop.on_status = errors.append, status.append
    with pytest.raises(RuntimeError, match="illegal memory access"):
        loop.run(max_chunks=3)
    assert errors and errors[0].startswith("Fatal error: CUDA error")
    assert status[-1] == "Stopped" and src._data is None
    assert loop.chunks_processed == 1


def test_host_decode_error_stays_caught(golden_iq, monkeypatch):
    """An exception of the host decode is the reference's "Decode error":
    logged, and the loop goes on to its last chunk."""
    from tetraear_tpu_torch.core.decoder import TetraDecoder

    def bad(self, scored):
        raise ValueError("malformed burst")
    monkeypatch.setattr(TetraDecoder, "decode_scored", bad)
    loop, _, frames = _run(CaptureLoop, golden_iq, max_chunks=3,
                           device="cpu", afc=False)
    assert loop.chunks_processed == 3 and frames == []


def test_listen_exits_nonzero_on_a_device_fault(golden_iq, tmp_path,
                                                 monkeypatch, capsys):
    """`listen` whose processor raises ends with the exception (a nonzero
    exit from `python -m`), no frame written."""
    monkeypatch.setattr(SignalProcessor, "process", _raise_cuda)
    out = tmp_path / "out.jsonl"
    with pytest.raises(RuntimeError, match="CUDA error"):
        cli.main(["listen", "--iq-file", str(golden_iq), "--no-afc",
                  "--device", "cpu", "-o", str(out)])
    assert "[ERROR] Fatal error: CUDA error" in capsys.readouterr().out
    assert not out.exists() or out.read_text() == ""


@pytest.mark.parametrize("command", ["listen", "tui", "scan", "waterfall"])
def test_cuda_without_a_card_names_device_cpu(golden_iq, monkeypatch,
                                              command):
    """--device cuda (the default) on a host without a card: the command
    refuses to run and names --device cpu; nothing falls back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = {"listen": ["listen", "--iq-file", str(golden_iq)],
            "tui": ["tui", "--iq-file", str(golden_iq)],
            "scan": ["scan", "392.4", "392.6", "--iq-file", str(golden_iq)],
            "waterfall": ["waterfall", str(golden_iq)]}[command]
    for extra in ([], ["--device", "cuda"]):
        with pytest.raises(SystemExit, match="--device cpu"):
            cli.main(argv + extra)


def test_meter_and_trace_dir(golden_iq, tmp_path, capsys):
    """ThroughputMeter is the reference's (the same rates on the same
    clock), and `listen --trace-dir` writes a torch.profiler Chrome
    trace of the session."""
    from tetraear_tpu.utils.metrics import ThroughputMeter as JaxMeter

    class Clock:
        t = 0.0

        def __call__(self):
            return self.t
    meters = []
    for cls in (ThroughputMeter, JaxMeter):
        clock = Clock()
        m = cls(window_s=5.0, clock=clock)
        for _ in range(70):
            clock.t += 0.1
            m.record(240_000, 2)
        meters.append((m.rates(), m.summary(), m.total_frames))
    assert meters[0] == meters[1]
    trace = tmp_path / "trace"
    assert cli.main(["listen", "--iq-file", str(golden_iq), "--no-afc",
                     "--max-chunks", "1", "--device", "cpu",
                     "--trace-dir", str(trace)]) == 0
    capsys.readouterr()
    events = json.loads((trace / "trace.json").read_text())["traceEvents"]
    assert any("aten::" in str(e.get("name", "")) for e in events)


@pytest.mark.cuda
def test_capture_loop_on_card_equals_cpu(golden_iq):
    """The loop on the card (spectrum, detection, demod and sync scores
    there) decodes the CPU run's frames, key for key, AFC on and off."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for afc in (False, True):
        a = _run(CaptureLoop, golden_iq, device="cuda:0", afc=afc)[2]
        b = _run(CaptureLoop, golden_iq, device="cpu", afc=afc)[2]
        assert _dump(a, trec) == _dump(b, trec)
        assert len(a) >= (1 if afc else 6)
