"""The port's operator commands and views against the JAX package's, on
the CPU: `waterfall`, `frames`, `codec`, `devices`, the session tables
(`ui/session.py`), settings and presets, the text helpers, the terminal
UI's view and the headless `tui`.

Inputs are the golden frame log and captures made with numpy from fixed
seeds.  The waterfall's power rows are held within 1e-3 dB on every bin
within 60 dB of the capture's peak and within 0.05 dB on every bin (the
repo's spectrum tolerance: FFT rounding is an absolute error, which
grows in dB as a bin's power falls); the rendering of the same rows, the
command lines' output, the codec's bytes and the views must be equal.
A fault of the device in the `tui`'s receive loop must reach the main
thread."""

import re
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from tetraear_tpu.io import capture as jcapture
from tetraear_tpu.ops import spectrum as jsp
from tetraear_tpu.ui import cli as jax_cli
from tetraear_tpu.ui import session as jsession
from tetraear_tpu.ui import settings as jsettings
from tetraear_tpu.ui import text as jtext
from tetraear_tpu.ui import tui as jtui
from tetraear_tpu.ui import waterfall as jwf

from tetraear_tpu_torch.io import capture as tcapture
from tetraear_tpu_torch.io import replay as treplay
from tetraear_tpu_torch.models.receiver import SignalProcessor
from tetraear_tpu_torch.ui import cli
from tetraear_tpu_torch.ui import session as tsession
from tetraear_tpu_torch.ui import settings as tsettings
from tetraear_tpu_torch.ui import text as ttext
from tetraear_tpu_torch.ui import tui as ttui
from tetraear_tpu_torch.ui import waterfall as twf
from tetraear_tpu_torch.utils import synth as tsynth

REPO = Path(__file__).resolve().parents[2]
GOLDEN = (REPO / "tests" / "conformance" / "fixtures"
          / "long_mixed.golden.jsonl")
DB_TOL = 1e-3          # dB, bins within 60 dB of the capture's peak
DB_TOL_ALL = 0.05      # dB, every bin


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
    x, _ = tsynth.planted_single("ref-compat", num_frames=12)
    path = tmp_path_factory.mktemp("iq") / "golden.cf32"
    treplay.save_iq(path, x, sample_rate=2.4e6, center_frequency=390.865e6)
    return path


@pytest.fixture(scope="module")
def golden_frames():
    from tetraear_tpu_torch.io.frames_query import read_frames
    return list(read_frames(GOLDEN))


def _out_lines(capsys) -> list:
    """Captured stdout without the console's log records."""
    return [line for line in capsys.readouterr().out.splitlines()
            if not re.match(r"\d{4}-\d\d-\d\d ", line)
            and not line.startswith("[DEVICE]")]


# --- waterfall ---------------------------------------------------------------

@pytest.mark.parametrize("capture", ["planted_single", "planted_scan"])
def test_waterfall_rows_equal_the_reference(capture):
    """The 200 rows of 2048-point spectra over a whole capture (the
    command's defaults): within the spectrum tolerance of the JAX
    package's, and rendered to the same pixels from the same rows."""
    x = (tsynth.planted_single("ref-compat", num_frames=12)[0]
         if capture == "planted_single" else tsynth.planted_scan()[0])
    n_fft, rows = 2048, 200
    got = cli.waterfall_power(x, n_fft, rows, "cpu")
    hop = max((len(x) - n_fft) // (rows - 1), 1)
    want = np.asarray(jsp.spectrum_frames_dbfs(jax.numpy.asarray(x), n_fft,
                                               hop))
    assert got.shape == want.shape and got.shape[0] >= rows
    live = want > want.max() - 60.0
    assert np.abs(got - want)[live].max() <= DB_TOL
    assert np.abs(got - want).max() <= DB_TOL_ALL
    images = []
    for wf in (twf, jwf):
        buf = wf.WaterfallBuffer(history=rows)
        for row in want[:rows]:
            buf.update_spectrum(np.zeros(n_fft), row)
        lo, hi = np.percentile(want, 5), np.percentile(want, 99.9)
        images.append(wf.render_waterfall_rgb(buf, floor_db=lo, top_db=hi))
    np.testing.assert_array_equal(images[0], images[1])
    assert images[0].shape == (rows, n_fft, 3)


def test_waterfall_cli_like_the_reference(golden_iq, tmp_path, capsys):
    """`waterfall <iq> -o x.png --rows 32` and `-o x.ppm`: images of the
    reference's size; the PPM's pixels within one level of the JAX CLI's
    (its rows agree within the spectrum tolerance)."""
    for suffix in (".png", ".ppm"):
        mine, ref = tmp_path / f"port{suffix}", tmp_path / f"jax{suffix}"
        assert cli.main(["waterfall", str(golden_iq), "-o", str(mine),
                         "--rows", "32", "--device", "cpu"]) == 0
        assert jax_cli.main(["waterfall", str(golden_iq), "-o", str(ref),
                             "--rows", "32"]) == 0
        lines = _out_lines(capsys)
        assert lines[0].startswith("[OK] 2048x32 waterfall") and \
            lines[0].endswith(f"-> {mine}")
        a, b = mine.read_bytes(), ref.read_bytes()
        if suffix == ".png":
            assert a[:8] == b"\x89PNG\r\n\x1a\n" and a[16:24] == b[16:24]
        else:
            head = b"P6\n2048 32\n255\n"
            assert a.startswith(head) and b.startswith(head)
            pa = np.frombuffer(a[len(head):], np.uint8).astype(int)
            pb = np.frombuffer(b[len(head):], np.uint8).astype(int)
            assert np.abs(pa - pb).max() <= 1


# --- frames, codec, devices --------------------------------------------------

@pytest.mark.parametrize("argv", [
    ["--stats"], ["--stats", "--top", "3"], ["--type", "MAC-RESOURCE"],
    ["--type", "mac-frag", "--type", "MAC-END/RES"], ["--group", "1001"],
    ["--encrypted", "--stats"], ["--clear"], ["--sds-only"],
    ["--user", "1234"], ["--timeslot", "0"], ["--out"], ["--stats", "--out"]],
    ids=lambda a: "_".join(x.strip("-") for x in a))
def test_frames_cli_equals_jax_cli(tmp_path, capsys, argv):
    """`frames <golden log>` with each filter, the stats panel and -o:
    the JAX CLI's lines and file."""
    outs = []
    for main, name in ((cli.main, "port"), (jax_cli.main, "jax")):
        args = [a if a != "--out" else "-o" for a in argv]
        dst = tmp_path / f"{name}.jsonl"
        if "-o" in args:
            args.insert(args.index("-o") + 1, str(dst))
        assert main(["frames", str(GOLDEN), *args]) == 0
        lines = [line.replace(str(dst), "DST") for line in _out_lines(capsys)]
        outs.append((lines, dst.read_bytes() if dst.exists() else None))
    assert outs[0] == outs[1]
    assert outs[0][0]


def test_frames_missing_log(tmp_path, capsys):
    missing = str(tmp_path / "nope.jsonl")
    assert cli.main(["frames", missing]) == jax_cli.main(["frames",
                                                          missing]) == 1
    lines = _out_lines(capsys)
    assert lines[0] == lines[1] == f"[FAIL] {missing} not found"


def test_codec_cli_round_trip_equals_jax_cli(tmp_path, capsys):
    """`codec encode` of synthesized speech, then `codec decode`: the same
    .tet blocks and the same WAV as the JAX CLI (the port's codec is
    built from native/codec into build/codec/)."""
    from tetraear_tpu_torch.audio.voice import VoiceEncoder
    if not VoiceEncoder().working:
        pytest.skip("no C compiler: the port's codec is not built")
    pcm = tmp_path / "speech.pcm"
    tsynth.make_test_speech(0.5).tofile(pcm)
    files = {}
    for main, name in ((cli.main, "port"), (jax_cli.main, "jax")):
        tet, wav = tmp_path / f"{name}.tet", tmp_path / f"{name}.wav"
        assert main(["codec", "encode", str(pcm), "-o", str(tet)]) == 0
        assert main(["codec", "decode", str(tet), "-o", str(wav)]) == 0
        lines = [line.replace(str(tet), "TET").replace(str(wav), "WAV")
                 for line in _out_lines(capsys)]
        files[name] = (tet.read_bytes(), wav.read_bytes(), lines)
    assert files["port"] == files["jax"]
    assert len(files["port"][0]) % 1380 == 0 and len(files["port"][0]) > 0


def _fake_bladerf():
    return types.SimpleNamespace(get_device_list=lambda: [
        types.SimpleNamespace(serial="abc123", usb_bus=1, usb_addr=2,
                              instance=0)])


@pytest.mark.parametrize("present", [True, False])
def test_devices_cli_equals_jax_cli(monkeypatch, capsys, present):
    """`devices` with a mocked `bladerf` module (the device list of
    tests/unit/test_capture_driver.py) and without one: the JAX CLI's
    lines and exit codes (1 without the module, as on the card's host)."""
    for module in (tcapture, jcapture):
        monkeypatch.setattr(module, "BLADERF_AVAILABLE", present)
        monkeypatch.setattr(module, "bladerf",
                            _fake_bladerf() if present else None)
    rc = cli.main(["devices"])
    mine = _out_lines(capsys)
    assert rc == jax_cli.main(["devices"]) == (0 if present else 1)
    assert mine == _out_lines(capsys)
    assert mine == (["serial=abc123 bus=1 addr=2"] if present
                    else ["bladerf module not available on this host"])


def test_bladerf_capture_reads_like_the_reference(monkeypatch):
    """BladeRFCapture over a mocked sync_rx: the same SC16-Q11 samples."""
    class FakeBladeRF:
        def __init__(self, ident=None):
            self.channel = types.SimpleNamespace()

        def Channel(self, ch):
            return self.channel

        def sync_config(self, **kw):
            pass

        def sync_rx(self, buf, num_samples, timeout_ms=0):
            buf[:] = np.arange(num_samples * 2, dtype=np.int16).tobytes()

        def close(self):
            pass
    fake = types.SimpleNamespace(
        BladeRF=FakeBladeRF, CHANNEL_RX=lambda i: i,
        GainMode=types.SimpleNamespace(Default="d", Manual="m"),
        ChannelLayout=types.SimpleNamespace(RX_X1="rx"),
        Format=types.SimpleNamespace(SC16_Q11="sc16"))
    got = []
    for module in (tcapture, jcapture):
        monkeypatch.setattr(module, "bladerf", fake)
        monkeypatch.setattr(module, "BLADERF_AVAILABLE", True)
        cap = module.BladeRFCapture(device_identifier="abc123")
        assert cap.open()
        got.append(cap.read_samples(4096))
        cap.close()
    np.testing.assert_array_equal(got[0], got[1])


# --- session, settings, text, view -------------------------------------------

def test_session_tables_equal_the_reference(golden_frames):
    """SessionAggregator over the golden log (with SDS fragments
    reassembled): the same rows, tables, messages and summary."""
    extra = [
        {"number": 90, "type_name": "MAC-FRAG", "address_source": 77,
         "address_destination": 9, "fragment_id": 3, "fragment_index": 0,
         "mac_pdu": {"data": "02 01 48 45"}},
        {"number": 91, "type_name": "MAC-END", "address_source": 77,
         "address_destination": 9, "fragment_id": 3, "fragment_index": 1,
         "is_last_fragment": True, "mac_pdu": {"data": b"LLO!"}},
        {"number": 92, "type_name": "MAC-RESOURCE",
         "call_metadata": {"talkgroup_id": 9001, "call_identifier": 4,
                           "call_type": "Group", "source_ssi": 11,
                           "dest_ssi": 12, "mcc": 260, "mnc": 1}}]
    a, b = tsession.SessionAggregator(), jsession.SessionAggregator()
    for frame in golden_frames + extra:
        assert a.on_frame(dict(frame)) == b.on_frame(dict(frame))
    for name in ("frames", "calls", "groups", "users", "messages",
                 "frame_count", "decrypted_count"):
        assert getattr(a, name) == getattr(b, name), name
    assert a.summary() == b.summary()
    assert a.messages


def test_settings_and_presets_equal_the_reference(tmp_path, monkeypatch):
    """SettingsManager / FrequencyManager: the same defaults, files and
    round trips in the user data directory."""
    out = []
    for name, mod in (("port", tsettings), ("ref", jsettings)):
        monkeypatch.setenv("TETRAEAR_TPU_DATA_DIR", str(tmp_path / name))
        s = mod.SettingsManager()
        s.set("gain", 31.5)
        s.save()
        f = mod.FrequencyManager()
        f.add(392.5, "HOME", "planted")
        again = mod.SettingsManager()
        out.append((s.settings, again.get("gain"), f.get_all(),
                    (tmp_path / name / "settings.json").read_text(),
                    (tmp_path / name / "frequencies.json").read_text()))
    assert out[0] == out[1]


def test_text_helpers_equal_the_reference(golden_frames):
    texts = ["", "ab", "HELLO", "[TXT] HELLO HELLO", "[GSM7] Ωmega",
             "hi there",
             "[TXT] Meet at the north gate at 10", "\x01\x02bin", "[LOC] Lat:"
             " 52.1 Lon: 21.0", "[LIP] 0a48123456", "[GPS] fix", "ABCD",
             "[BIN-ENC] 12 bytes", "lowercase words only here please"]
    for t in texts:
        assert ttext.is_readable_text(t) == jtext.is_readable_text(t), t
    frames = golden_frames + [{"decoded_text": t} for t in texts] + [
        {"type_name": "MAC-BROADCAST",
         "additional_info": {"description": "System info"}},
        {"type_name": "MAC-RESOURCE", "additional_info": {"talkgroup": 5}}]
    for f in frames:
        assert ttext.format_location_data(f) == jtext.format_location_data(f)
        assert (ttext.format_binary_metadata(f)
                == jtext.format_binary_metadata(f))


def _render(pkg, state, width=110) -> str:
    from rich.console import Console
    console = Console(record=True, width=width, force_terminal=True)
    console.print(pkg.build_view(state, width))
    return console.export_text()


def test_build_view_equals_the_reference(golden_frames):
    """TuiState fed the same spectra, frames and toggles: build_view
    renders the same text, at zoom 1 and zoomed."""
    clock = lambda: 100.0  # noqa: E731
    states = []
    for pkg, wf in ((ttui, twf), (jtui, jwf)):
        st = pkg.TuiState(frequency_hz=391e6)
        st.machine = wf.TetraStatusMachine(clock=clock)
        freqs = np.linspace(390.0, 392.0, 400)
        for k in range(12):
            power = -90 + 50 * np.exp(-((freqs - 391.0 - 0.01 * k) / 0.02)
                                      ** 2)
            st.waterfall.update_spectrum(freqs, power)
        st.machine.on_signal(True)
        for frame in golden_frames:
            st.machine.on_frame(frame)
            st.on_frame_row(st.session.on_frame(dict(frame)))
        st.signal_power_db, st.chunks, st.frames = -42.5, 7, len(golden_frames)
        states.append(st)
    assert _render(ttui, states[0]) == _render(jtui, states[1])
    for st in states:
        st.zoom, st.view_center_mhz = 4.0, 391.2
    assert _render(ttui, states[0]) == _render(jtui, states[1])


# --- the terminal UI, headless -----------------------------------------------

def _summary(out: str) -> list:
    """The session summary printed after the live view (which ends its
    last frame without a newline)."""
    return out[out.rindex("Frames: "):].splitlines()


def test_tui_headless_replay_equals_jax_cli(golden_iq, capsys):
    """`tui --iq-file f --no-afc --max-chunks 4` without a terminal (as
    tests/integration/test_end_to_end.py:495 runs it): exits 0 when the
    loop drains, the text reaches the view, and the session summary is
    the JAX CLI's."""
    argv = ["tui", "--iq-file", str(golden_iq), "--no-afc", "--max-chunks",
            "4", "--no-auto-decrypt"]
    assert cli.main([*argv, "--device", "cpu"]) == 0
    mine = capsys.readouterr().out
    assert jax_cli.main(argv) == 0
    theirs = capsys.readouterr().out
    assert "HELLO HELLO" in mine
    assert _summary(mine) == _summary(theirs)
    assert _summary(mine)[1].startswith("Talkgroups: 1  Calls: 1")


def test_tui_reraises_a_device_fault(golden_iq, monkeypatch, capsys):
    """The receive loop's device fault (a processor that raises) stops
    the view and is re-raised on the main thread; the reference's daemon
    worker would drop it."""
    def boom(*_args, **_kw):
        raise RuntimeError("CUDA error: out of memory")
    monkeypatch.setattr(SignalProcessor, "process", boom)
    with pytest.raises(RuntimeError, match="out of memory"):
        cli.main(["tui", "--iq-file", str(golden_iq), "--no-afc",
                  "--max-chunks", "4", "--duration", "30", "--device",
                  "cpu"])
    assert "Frames: 0" not in capsys.readouterr().out


def test_tui_view_follows_the_loop(golden_iq):
    """TerminalUI wired to the port's CaptureLoop: frames, rows, texts
    and the spectrum reach its state, as the reference's test_tui.py
    checks for the JAX package."""
    from tetraear_tpu_torch.ui.capture_loop import CaptureLoop
    src = treplay.FileReplaySource(golden_iq, sample_rate=2.4e6,
                                   frequency=390.865e6)
    loop = CaptureLoop(src, auto_decrypt=False, always_decode=True,
                       afc=False, device="cpu")
    ui = ttui.TerminalUI(loop)
    loop.run(max_chunks=3)
    st = ui.state
    assert st.frames == loop.frames_decoded >= 4
    assert st.waterfall.current_power is not None
    assert "[TXT] HELLO HELLO" in st.messages
    assert "HELLO HELLO" in _render(ttui, st)
    assert torch.device("cpu") == loop.device
