"""The port's tools (tetraear_tpu_torch/tools/) against the JAX package's
(tools/*.py), on the CPU.

Each JAX tool runs here through its own `main()` (sys.argv set, the
working directory a temporary one; `bench_scaling --virtual 4` in a
subprocess, since this process's JAX holds the conftest's 8 virtual
devices) and its twin through `main(argv)` with `--device cpu`, on the
same inputs: the conformance fixtures, or inputs made from a seed.

Held equal: make_fixture's IQ files and sidecars byte for byte; the
capture tools' printed lines and every file they write (frames JSONL,
WAV clips, text logs) once the run-id timestamps are cut from names and
lines; analyze_text's, bruteforce_keys', verify_codec's, codec_quality's
and list_bladerf_devices' output; sensitivity_sweep's JSON lines and its
per-slot CRC verdicts; bench_scaling's rows (devices, mesh, keys), with
each mesh's gathered step result held against JAX's sharded step on the
same input within tests/unit/test_torch_parallel.py's tolerances.

Every test ends within its own 55 s deadline (SIGALRM)."""

import contextlib
import importlib.util
import io
import json
import os
import re
import runpy
import signal
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tetraear_tpu.io import capture as jcapture
from tetraear_tpu.parallel import mesh as jmesh
from tetraear_tpu.parallel import sharded as jsh
from tetraear_tpu.config import ReceiverConfig as JaxReceiverConfig

from tetraear_tpu_torch.crypto.tea import TEAEncryptor
from tetraear_tpu_torch.io import capture as tcapture
from tetraear_tpu_torch.tools import (analyze_text, auto_capture,
                                      bench_scaling, bruteforce_keys,
                                      codec_quality, continuous_capture,
                                      decrypt_capture, list_bladerf_devices,
                                      listen_clear, make_fixture,
                                      sensitivity_sweep, verify_codec)

REPO = Path(__file__).resolve().parents[2]
FIXTURES = REPO / "tests" / "conformance" / "fixtures"
DEADLINE_S = 55
RUN_ID = re.compile(r"\d{8}_\d{6}")
RUN_ID_BYTES = re.compile(rb"\d{8}_\d{6}")


@pytest.fixture(autouse=True)
def _deadline():
    """A deadline of its own for each test: SIGALRM raises in it."""
    def expire(signum, frame):
        raise TimeoutError(f"the test ran past its {DEADLINE_S} s deadline")
    previous = signal.signal(signal.SIGALRM, expire)
    signal.alarm(DEADLINE_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, previous)


def _jax_tool(name: str):
    """tools/<name>.py as a module (its work sits under main())."""
    spec = importlib.util.spec_from_file_location(
        f"jax_tool_{name}", REPO / "tools" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _run_jax(name: str, argv: list, monkeypatch) -> int:
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *argv])
    return _jax_tool(name).main()


def _lines(capsys, *subs) -> list:
    """This test's printed lines since the last call, each substitution
    (old, new) applied and run ids cut."""
    out = capsys.readouterr().out
    for old, new in subs:
        out = out.replace(old, new)
    return RUN_ID.sub("RUN", out).splitlines()


def _tree(root: Path) -> dict:
    """{relative path with run ids cut: bytes with run ids cut} of every
    file under root."""
    return {RUN_ID.sub("RUN", str(p.relative_to(root))):
            RUN_ID_BYTES.sub(b"RUN", p.read_bytes())
            for p in sorted(root.rglob("*")) if p.is_file()}


# --- make_fixture --------------------------------------------------------

@pytest.mark.parametrize("argv", [
    [],
    ["--mapping", "pi4", "--true-rate"],
    ["--frames", "3", "--snr", "10", "--offset-hz", "1500", "--seed", "5",
     "--payload", "TOOLS TEST"],
    ["--downlink", "--slots", "8", "--snr", "12", "--offset-hz", "-700"],
], ids=["default", "pi4-true-rate", "snr-offset-payload", "downlink"])
def test_make_fixture_files_equal_jax_tool(tmp_path, monkeypatch, capsys,
                                           argv):
    files = {}
    for name, run in (("jax", lambda a: _run_jax("make_fixture", a,
                                                  monkeypatch)),
                      ("port", make_fixture.main)):
        out = tmp_path / name / "f.cf32"
        out.parent.mkdir()
        assert run([str(out), *argv]) == 0
        files[name] = (_lines(capsys, (str(out), "OUT")), _tree(out.parent))
    assert files["port"] == files["jax"]
    assert set(files["port"][1]) == {"f.cf32", "f.cf32.json"}
    assert len(files["port"][1]["f.cf32"]) > 100_000


# --- the capture tools ----------------------------------------------------

def _keys_file(path: Path) -> Path:
    """An ALGORITHM:KEY_ID:HEX key file of seeded random TEA keys."""
    rng = np.random.default_rng(7)
    lines = ["# seeded test keys"]
    for i in range(6):
        alg, n = ("TEA1", 10) if i % 2 == 0 else ("TEA2", 16)
        lines.append(f"{alg}:{i}:{rng.bytes(n).hex().upper()}")
    path.write_text("\n".join(lines) + "\n")
    return path


CAPTURES = {
    "continuous-clean": ("continuous_capture", "clean.cf32", []),
    "continuous-encrypted": ("continuous_capture", "encrypted.cf32",
                             ["--max-chunks", "2"]),
    "listen_clear-clean": ("listen_clear", "clean.cf32", []),
    "auto-encrypted": ("auto_capture", "encrypted.cf32",
                       ["--attempts", "2", "--chunks-per-attempt", "2",
                        "--key-file", "KEYS"]),
    "decrypt-encrypted": ("decrypt_capture", "encrypted.cf32",
                          ["-k", "KEYS"]),
    "decrypt-clean": ("decrypt_capture", "clean.cf32", ["-k", "KEYS"]),
}
PORT_TOOLS = {"continuous_capture": continuous_capture,
              "listen_clear": listen_clear, "auto_capture": auto_capture,
              "decrypt_capture": decrypt_capture}


@pytest.mark.parametrize("case", list(CAPTURES))
def test_capture_tool_equals_jax_tool(tmp_path, monkeypatch, capsys, case):
    """The tool on a replayed fixture: the same printed lines and the same
    logs/ and records/ files (frames JSONL, WAV clips, text logs)."""
    tool, fixture, extra = CAPTURES[case]
    keys = _keys_file(tmp_path / "keys.txt")
    argv = ["--iq-file", str(FIXTURES / fixture),
            *[str(keys) if a == "KEYS" else a for a in extra]]
    got = {}
    for name in ("jax", "port"):
        cwd = tmp_path / name
        cwd.mkdir()
        monkeypatch.chdir(cwd)
        if name == "jax":
            rc = _run_jax(tool, argv, monkeypatch)
        else:
            rc = PORT_TOOLS[tool].main([*argv, "--device", "cpu"])
        got[name] = (rc, _lines(capsys), _tree(cwd))
    assert got["port"] == got["jax"]
    rc, lines, files = got["port"]
    assert any(f.endswith(".jsonl") or f.endswith(".txt") for f in files)
    if tool != "listen_clear":
        frames = [json.loads(line) for f, data in files.items()
                  if f.endswith(".jsonl") for line in data.splitlines()]
        assert frames, files.keys()


@pytest.mark.parametrize("tool", ["continuous_capture", "listen_clear",
                                  "auto_capture", "decrypt_capture",
                                  "sensitivity_sweep", "bench_scaling"])
def test_device_tool_refuses_cuda_without_a_card(tmp_path, monkeypatch,
                                                 tool):
    """--device defaults to cuda; with no card the tool exits naming
    --device cpu before it writes anything, and never falls back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    module = {**PORT_TOOLS, "sensitivity_sweep": sensitivity_sweep,
              "bench_scaling": bench_scaling}[tool]
    argv = ([] if tool in ("sensitivity_sweep", "bench_scaling")
            else ["--iq-file", str(FIXTURES / "clean.cf32")])
    with pytest.raises(SystemExit) as e:
        module.main(argv)
    assert "--device cpu" in str(e.value.code)
    assert list(tmp_path.iterdir()) == []


# --- offline triage ---------------------------------------------------------

def _frames_log(path: Path) -> tuple:
    """A frames JSONL made from a seed: clear frames with texts (GSM7,
    binary, short, location), encrypted frames with MAC payloads (one
    encrypted under a key of the returned key file, holding an SDS-1
    text), and frames without payloads."""
    keys = _keys_file(path.parent / "keys.txt")
    alg, _, key_hex = keys.read_text().splitlines()[3].split(":")
    plain = b"\x05\x00\x1aMEET AT THE NORTH GATE NOW"
    plain += b"\x00" * (-len(plain) % 8)
    secret = TEAEncryptor(bytes.fromhex(key_hex), alg).encrypt(plain)
    rng = np.random.default_rng(11)
    words = ["HELLO", "UNIT", "MOVE", "NORTH", "GATE", "CALL", "BASE"]
    frames = []
    for i in range(40):
        kind = i % 5
        frame = {"number": i, "type_name": ["MAC-RESOURCE", "MAC-DATA",
                                            "MAC-FRAG"][i % 3],
                 "encrypted": kind in (3, 4)}
        if kind == 0:
            frame["decoded_text"] = "[GSM7] " + " ".join(
                rng.choice(words, 3))
            frame["mac_pdu"] = {"data": rng.bytes(12).hex()}
        elif kind == 1:
            frame["sds_message"] = ["[BIN] 0a0b", "ab", "[LOC] 52.1 4.3",
                                    "[SDS-1] TEXT " + str(i)][i % 4]
        elif kind == 3:
            data = secret if i == 13 else rng.bytes(8 * (1 + i % 3))
            frame["mac_pdu"] = {"data": data.hex()}
        elif kind == 4:
            frame["mac_pdu"] = {"data": None} if i % 2 else {}
        frames.append(frame)
    path.write_text("".join(json.dumps(f) + "\n" for f in frames))
    return path, keys


@pytest.mark.parametrize("argv", [[], ["--limit", "3"]])
def test_analyze_text_equals_jax_tool(tmp_path, monkeypatch, capsys, argv):
    log, _ = _frames_log(tmp_path / "frames.jsonl")
    assert _run_jax("analyze_text", [str(log), *argv], monkeypatch) == 0
    want = _lines(capsys)
    assert analyze_text.main([str(log), *argv]) == 0
    got = _lines(capsys)
    assert got == want
    assert got[0] == "Found 12 unencrypted text frames"


@pytest.mark.parametrize("source", ["seeded", "golden"])
def test_bruteforce_keys_equals_jax_tool(tmp_path, monkeypatch, capsys,
                                         source):
    """The seeded log (one frame under a key of the file: found) and the
    encrypted golden capture's frames."""
    log, keys = _frames_log(tmp_path / "frames.jsonl")
    if source == "golden":
        log = FIXTURES / "encrypted.golden.jsonl"
    argv = [str(log), "-k", str(keys), "--top", "3"]
    assert _run_jax("bruteforce_keys", argv, monkeypatch) == 0
    want = _lines(capsys)
    assert bruteforce_keys.main(argv) == 0
    got = _lines(capsys)
    assert got == want
    if source == "seeded":
        assert any(line.endswith("-> [SDS-1] MEET AT THE NORTH GATE NOW")
                   for line in got)


# --- devices and the codec ------------------------------------------------

@pytest.mark.parametrize("present", [True, False])
def test_list_bladerf_devices_equals_jax_tool(monkeypatch, capsys, present):
    """With a mocked `bladerf` module (tests/unit/test_torch_operator.py's
    device list) and without one."""
    fake = types.SimpleNamespace(get_device_list=lambda: [
        types.SimpleNamespace(serial="abc123", usb_bus=1, usb_addr=2,
                              instance=0)])
    for module in (tcapture, jcapture):
        monkeypatch.setattr(module, "BLADERF_AVAILABLE", present)
        monkeypatch.setattr(module, "bladerf", fake if present else None)
    with pytest.raises(SystemExit) as e:
        runpy.run_path(str(REPO / "tools" / "list_bladerf_devices.py"),
                       run_name="__main__")
    want = _lines(capsys)
    assert list_bladerf_devices.main() == e.value.code == (0 if present
                                                           else 1)
    assert _lines(capsys) == want


@pytest.fixture(scope="module")
def codec_dir() -> Path:
    """The port's codec programs, built from native/codec/."""
    from tetraear_tpu_torch.audio.voice import build_codec
    built = build_codec()
    if built is None:
        pytest.skip("no C compiler: the port's codec is not built")
    return built


def test_verify_codec_equals_jax_tool(monkeypatch, capsys, codec_dir):
    argv = ["--codec-dir", str(codec_dir)]
    assert _run_jax("verify_codec", argv, monkeypatch) == 0
    want = _lines(capsys)
    assert verify_codec.main(argv) == 0
    assert _lines(capsys) == want
    assert want[-1] == "[PASS] codec verification complete"
    # the default is the port's own build
    assert verify_codec.main([]) == 0
    assert _lines(capsys) == want


def test_verify_codec_without_programs(tmp_path, capsys):
    assert verify_codec.main(["--codec-dir", str(tmp_path)]) == 1
    lines = _lines(capsys)
    assert lines[1:5] == [f"  {p}: NOT FOUND" for p in
                          ("cdecoder", "ccoder", "sdecoder", "scoder")]
    assert "native/codec/" in lines[-1]


@pytest.mark.parametrize("json_out", [False, True])
def test_codec_quality_equals_jax_tool(monkeypatch, capsys, codec_dir,
                                       json_out):
    argv = ["--seeds", "3,7", "--seconds", "0.5", "--bin", str(codec_dir),
            *(["--json"] if json_out else [])]
    assert _run_jax("codec_quality", argv, monkeypatch) == 0
    want = _lines(capsys)
    assert codec_quality.main(argv) == 0
    assert _lines(capsys) == want
    if json_out:
        rows = json.loads(want[0])
        assert len(rows) == 6 and all(r["corr"] > 0.5 for r in rows)


# --- sensitivity_sweep ------------------------------------------------------

SWEEP_SNRS = ["-6", "-14", "-15"]
SWEEP_ARGV = ["--slots", "12", "--seeds", "1", "--snrs", *SWEEP_SNRS]


def test_sensitivity_sweep_equals_jax_tool(monkeypatch, capsys):
    """--slots 12 --seeds 1 at -6, -14 and -15 dB: the JSON lines equal
    the JAX tool's."""
    assert _run_jax("sensitivity_sweep", SWEEP_ARGV, monkeypatch) == 0
    want = _lines(capsys)
    assert sensitivity_sweep.main([*SWEEP_ARGV, "--device", "cpu"]) == 0
    assert _lines(capsys) == want
    rows = [json.loads(line) for line in want]
    assert [r["snr_wideband_db"] for r in rows] == [-6, -14, -15]
    assert rows[0]["crc_pass_rate"] >= 0.9 > rows[2]["crc_pass_rate"]


def test_sensitivity_sweep_verdicts_equal_jax_receiver(capsys):
    """The same sweep: each row the tool prints, and every slot's CRC
    verdict equal to JAX's DownlinkReceiver's on the same IQ (at -14 and
    -15 dB about half the slots sit at the edge)."""
    from tetraear_tpu.models.downlink import (DownlinkConfig,
                                              DownlinkReceiver,
                                              DownlinkTransmitter)
    from tetraear_tpu.utils.synth import make_mac_block_bits
    assert sensitivity_sweep.main([*SWEEP_ARGV, "--device", "cpu"]) == 0
    printed = _lines(capsys)
    tx = DownlinkTransmitter(DownlinkConfig())
    bits = tx.stream_bits(12, payloads={
        k: make_mac_block_bits(b"SENSITIVITY", seed=k)
        for k in range(12) if k % 4 != 0})
    got = sensitivity_sweep.sweep([float(s) for s in SWEEP_SNRS], 12, 1,
                                  device="cpu")
    for snr, (row, verdicts) in zip(SWEEP_SNRS, got):
        frames = DownlinkReceiver().receive(tx.modulate(
            bits, snr_db=float(snr), seed=0))
        assert verdicts == [[f.crc_ok for f in frames]], snr
        assert json.dumps(row) in printed


# --- bench_scaling ----------------------------------------------------------

BENCH_ARGS = ["--virtual", "4", "--per-device-samples", "33800",
              "--iters", "1"]


def _bench_jax(profile: str, extra: list) -> list:
    proc = subprocess.run(
        [sys.executable, str(REPO / "tools" / "bench_scaling.py"),
         *BENCH_ARGS, "--profile", profile, *extra],
        capture_output=True, text=True, timeout=45, cwd=REPO,
        env={**os.environ, "JAX_PLATFORMS": "cpu",
             "XLA_FLAGS": ""})
    assert proc.returncode == 0, proc.stderr[-2000:]
    return proc.stdout.splitlines()


def _owned(halo: int, t_local: int, sps: int, decim: int,
           margin: int = 8) -> slice:
    """Bit range of a segment's owned interior, `margin` symbols inside
    the filter edges (tests/unit/test_torch_parallel.py)."""
    h = (halo // decim) // sps
    own = (t_local // decim) // sps
    return slice(2 * (h + margin), 2 * (h + own - margin))


def _hold_ref(got: dict, want, carrier: int, t_local: int) -> None:
    """The staged step's tolerances: best phases equal and the same on
    every time shard; bits on owned interiors >= 0.995 equal (noise
    carriers: near-zero symbols flip under another f32 sum order); sync
    scores within 1e-4 wherever their 22-bit window agrees."""
    want_bits = np.asarray(want.bits)
    want_corr = np.asarray(want.sync_corr)
    np.testing.assert_array_equal(got["best_phase"],
                                  np.asarray(want.best_phase))
    assert (got["best_phase"] == got["best_phase"][:, :1]).all()
    assert got["bits"].shape == want_bits.shape == (carrier,) + \
        got["bits"].shape[1:]
    sl = _owned(bench_scaling.REF_HALO, t_local, 13, 10)
    same = got["bits"] == want_bits
    assert same[..., sl].mean() >= 0.995
    window = np.lib.stride_tricks.sliding_window_view(same, 22, axis=-1)
    agree = window.all(axis=-1)
    assert agree[..., sl].mean() >= 0.9
    np.testing.assert_allclose(got["sync_corr"][agree],
                               want_corr[agree], atol=1e-4)


def _hold_etsi(got: dict, want, t_local: int) -> None:
    """The etsi step on noise: best phases equal, and on the owned
    interiors (ShardedDownlinkReceiver.stitch's region) every LLR's sign
    equal, 99 % of them within test_torch_parallel.py's 1e-3 and all
    within 1e-2.  That file's 1e-3 holds planted signals; a noise symbol
    near zero magnitude carries the channelizer's f32 phase rounding
    (mixer phases reach ~4e3 rad here, an ulp of 2.4e-4 rad) into its
    LLR, up to 3.4e-3 on 0.7 % of them at (2, 2)."""
    np.testing.assert_array_equal(got["best_phase"],
                                  np.asarray(want.best_phase))
    w = np.asarray(want.soft_bits)
    assert got["soft_bits"].shape == w.shape
    cfg = JaxReceiverConfig()
    sps, decim = cfg.etsi_sps, cfg.decimation_factor
    lo = 2 * (((bench_scaling.ETSI_HALO // decim) * 3 // 10) // sps)
    own = slice(lo, lo + 2 * (((t_local // decim) * 3 // 10) // sps))
    a, b = got["soft_bits"][..., own], w[..., own]
    assert np.array_equal(np.sign(a), np.sign(b))
    err = np.abs(a - b)
    assert (err <= 1e-3).mean() >= 0.99 and err.max() <= 1e-2, err.max()


BENCH_EXTRA = {"ref": ["--overhead"], "etsi": []}
_BENCH_RUNS: dict = {}


def _bench_port(profile: str, tmp_path_factory) -> tuple:
    """The port's tool on the profile, run once for this module's three
    tests of it: (printed lines, the directory of its <n>.npz results)."""
    if profile not in _BENCH_RUNS:
        out = tmp_path_factory.mktemp(f"bench_scaling_{profile}")
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            assert bench_scaling.main([*BENCH_ARGS, "--profile", profile,
                                       *BENCH_EXTRA[profile]],
                                      outputs=out) == 0
        _BENCH_RUNS[profile] = printed.getvalue().splitlines(), out
    return _BENCH_RUNS[profile]


@pytest.mark.parametrize("profile", ["ref", "etsi"])
def test_bench_scaling_rows(tmp_path_factory, profile):
    """--virtual 4 --per-device-samples 33800 --iters 1 (with --overhead
    on the ref profile): one row per mesh, (1, 1), (1, 2) and (2, 2),
    with the JAX tool's keys and a rate (the host's) above zero."""
    got, _ = _bench_port(profile, tmp_path_factory)
    assert got[0] == "# backend=cpu devices=4"
    rows = [json.loads(line) for line in got[1:]]
    keys = ["devices", "mesh", "samples_per_sec", "weak_scaling_efficiency"]
    keys_n = keys + (["sharding_overhead_efficiency"]
                     if BENCH_EXTRA[profile] else [])
    assert [(r["devices"], r["mesh"], sorted(r)) for r in rows] == [
        (1, [1, 1], sorted(keys)), (2, [1, 2], sorted(keys_n)),
        (4, [2, 2], sorted(keys_n))]
    assert all(r["samples_per_sec"] > 0 for r in rows)


@pytest.mark.parametrize("profile", ["ref", "etsi"])
def test_bench_scaling_equals_jax_tool(tmp_path_factory, profile):
    """The JAX tool on the same arguments: the same header, rows, meshes
    and keys (rates are the host's and are not compared)."""
    got, _ = _bench_port(profile, tmp_path_factory)
    want = _bench_jax(profile, BENCH_EXTRA[profile])
    assert got[0] == want[0] == "# backend=cpu devices=4"
    rows = [json.loads(line) for line in got[1:]]
    want_rows = [json.loads(line) for line in want[1:]]
    assert ([(r["devices"], r["mesh"], sorted(r)) for r in rows]
            == [(r["devices"], r["mesh"], sorted(r)) for r in want_rows])


@pytest.mark.parametrize("profile", ["ref", "etsi"])
def test_bench_scaling_results_hold_jax_steps(tmp_path_factory, profile):
    """Each mesh's gathered result, as the port's tool saves it, held
    against JAX's sharded step on the same input."""
    _, out = _bench_port(profile, tmp_path_factory)
    import jax
    cfg = JaxReceiverConfig()
    for n, (carrier, time_axis), x, offsets in bench_scaling.block_inputs(
            4, 33800, profile):
        mesh = jmesh.make_mesh(carrier=carrier, time=time_axis,
                               devices=jax.devices()[:n])
        xs, offs = jsh.shard_inputs(mesh, jnp.asarray(x), offsets)
        got_n = dict(np.load(out / f"{n}.npz"))
        if profile == "etsi":
            run, _ = jsh.build_sharded_step_etsi(
                mesh, cfg, halo=bench_scaling.ETSI_HALO)
            _hold_etsi(got_n, run(xs, offs), x.shape[-1] // time_axis)
        else:
            run = jsh.build_sharded_step(mesh, cfg,
                                         halo=bench_scaling.REF_HALO)
            _hold_ref(got_n, run(xs, offs), carrier,
                      x.shape[-1] // time_axis)


def test_bench_scaling_runs_in_a_started_world(tmp_path, capsys):
    """In a process whose world is started (a world of one here, as
    chip_smoke.py starts one on the card), the tool runs in that world
    and leaves it started."""
    import torch.distributed as dist
    from tetraear_tpu_torch.parallel.distributed import (
        initialize_distributed)
    initialize_distributed("cpu")
    try:
        assert bench_scaling.main(["--device", "cpu", "--iters", "1",
                                   "--per-device-samples", "33800",
                                   "--profile", "etsi"],
                                  outputs=tmp_path) == 0
        assert dist.is_initialized() and dist.get_world_size() == 1
    finally:
        dist.destroy_process_group()
    lines = _lines(capsys)
    assert lines[0] == "# backend=cpu devices=1"
    row = json.loads(lines[1])
    assert (row["devices"], row["mesh"]) == (1, [1, 1]) and len(lines) == 2
    assert np.isfinite(np.load(tmp_path / "1.npz")["soft_bits"]).all()
