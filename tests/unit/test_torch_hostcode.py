"""The port's own host code: it imports neither jax nor the JAX package
`tetraear_tpu`, and its copies of the reference's host modules (synth,
protocol parser, TEA, TetraDecoder, IQ replay, JSONL recorder) give the
reference's results on the same seeded inputs, exactly."""

import ast
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from tetraear_tpu.core.decoder import TetraDecoder as JaxDecoder
from tetraear_tpu.crypto import native as jnative
from tetraear_tpu.crypto import tea as jtea
from tetraear_tpu.io import recorder as jrec
from tetraear_tpu.io import replay as jreplay
from tetraear_tpu.protocol import parser as jparser
from tetraear_tpu.utils import synth as jsynth

from tetraear_tpu_torch.core.decoder import TetraDecoder
from tetraear_tpu_torch.crypto import native as tnative
from tetraear_tpu_torch.crypto import tea as ttea
from tetraear_tpu_torch.crypto.keys import COMMON_KEYS
from tetraear_tpu_torch.io import recorder as trec
from tetraear_tpu_torch.io import replay as treplay
from tetraear_tpu_torch.ops import crc as tcrc
from tetraear_tpu_torch.protocol import parser as tparser
from tetraear_tpu_torch.utils import synth as tsynth

REPO = Path(__file__).resolve().parents[2]
PORT = REPO / "tetraear_tpu_torch"

# a sys.meta_path finder refusing jax and the JAX package, installed
# before anything else in the subprocess (chip_smoke.py installs the same)
GUARD = '''
import sys
REFUSED = ("jax", "jaxlib", "tetraear_tpu")
class RefuseReference:
    def find_spec(self, name, path=None, target=None):
        if name.partition(".")[0] in REFUSED:
            raise ModuleNotFoundError(name + " is refused", name=name)
        return None
assert not [m for m in sys.modules if m.partition(".")[0] in REFUSED]
sys.meta_path.insert(0, RefuseReference())
'''


def _guarded(code: str, timeout: int = 600) -> str:
    proc = subprocess.run([sys.executable, "-c", GUARD + code], cwd=REPO,
                          capture_output=True, text=True, timeout=timeout)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


# --- the port stands alone ------------------------------------------------

def test_port_imports_and_decodes_with_the_reference_refused(tmp_path):
    """With jax and tetraear_tpu refused by an import hook: every module
    of the port imports (the downlink, the uplink and their host copies
    among them), `python -m tetraear_tpu_torch decode ... --device cpu`
    decodes a planted single-carrier capture and a planted 16-carrier
    capture (--conv s2d), each finding its text, and `downlink
    --simulate` and `uplink --simulate --continuous` decode their
    planted SDS texts and CMCE signalling."""
    x1, text1 = tsynth.planted_single("ref-compat")
    x16, want16 = tsynth.planted_wideband((3, 8))
    single, wide = tmp_path / "single.cf32", tmp_path / "wide.cf32"
    treplay.save_iq(single, x1)
    treplay.save_iq(wide, x16)
    out = _guarded(f'''
import importlib, json, pkgutil, runpy
import tetraear_tpu_torch
names = [m.name for m in pkgutil.walk_packages(tetraear_tpu_torch.__path__,
                                               "tetraear_tpu_torch.")]
for name in names:
    importlib.import_module(name)
print("imported", len(names))
for name in ("models.downlink", "models.uplink", "ops.rm3014",
             "ops.spectrum", "protocol.bursts", "protocol.layer3",
             "protocol.mac", "protocol.mle", "protocol.mm", "protocol.pdus",
             "protocol.cmce", "protocol.sds_tl", "core.calls",
             "audio.blocks", "audio.voice", "signal.detector",
             "signal.scanner", "ui.capture_loop", "ui.tui", "ui.session",
             "ui.waterfall", "io.capture", "io.frames_query",
             "utils.metrics", "parallel.mesh", "parallel.halo",
             "parallel.distributed", "parallel.sharded", "entry",
             "tools.make_fixture", "tools.continuous_capture",
             "tools.listen_clear", "tools.auto_capture",
             "tools.decrypt_capture", "tools.analyze_text",
             "tools.bruteforce_keys", "tools.list_bladerf_devices",
             "tools.verify_codec", "tools.codec_quality",
             "tools.sensitivity_sweep", "tools.bench_scaling",
             "tools.comm_analysis", "bench"):
    assert "tetraear_tpu_torch." + name in names, name

def run(*argv):
    sys.argv = ["tetraear_tpu_torch", *argv]
    try:
        runpy.run_module("tetraear_tpu_torch", run_name="__main__")
    except SystemExit as e:
        assert not e.code, e.code

def decode(iq, out, *extra):
    sys.argv = ["tetraear_tpu_torch", "decode", iq, "--device", "cpu",
                "-o", out, *extra]
    try:
        runpy.run_module("tetraear_tpu_torch", run_name="__main__")
    except SystemExit as e:
        assert not e.code, e.code
    with open(out) as f:
        return [json.loads(line) for line in f]

frames = decode({str(single)!r}, {str(tmp_path / "s.jsonl")!r})
assert {text1!r} in [f.get("sds_message") for f in frames], frames
frames = decode({str(wide)!r}, {str(tmp_path / "w.jsonl")!r},
                "--carriers", "16", "--conv", "s2d")
got = {{(f["carrier"], f.get("sds_message")) for f in frames}}
for k, text in {want16!r}.items():
    assert (k, text) in got, (k, got)
dl, ul = {str(tmp_path / "dl.jsonl")!r}, {str(tmp_path / "ul.jsonl")!r}
run("downlink", "--simulate", "--device", "cpu", "-o", dl)
with open(dl) as f:
    rows = [json.loads(line) for line in f]
assert "[TXT] DOWNLINK SDS #1" in [r["sds"] for r in rows], rows
assert any("DSetup: call 41" in " ".join(r["layer3"] or []) for r in rows)
run("uplink", "--simulate", "--continuous", "--device", "cpu", "-o", ul)
with open(ul) as f:
    layer3 = [json.loads(line)["layer3"] for line in f]
assert any("uplink report 7" in " ".join(x or []) for x in layer3), layer3
bad = [m for m in sys.modules if m.partition(".")[0] in REFUSED]
assert not bad, bad
print("decoded")
''')
    assert "decoded" in out
    assert int(out.split("imported ")[1].split()[0]) >= 74


def _names_reference(node) -> list:
    """Where an AST node names jax or the JAX package as a module: an
    import, an import_module / __import__ / find_spec call, or a string
    that is a dotted module path under tetraear_tpu."""
    refused = ("jax", "jaxlib", "tetraear_tpu")
    hits = []
    if isinstance(node, ast.Import):
        hits += [a.name for a in node.names
                 if a.name.partition(".")[0] in refused]
    elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
        if node.module.partition(".")[0] in refused:
            hits.append(node.module)
    elif isinstance(node, ast.Call) and node.args:
        fn = node.func
        name = fn.attr if isinstance(fn, ast.Attribute) else getattr(
            fn, "id", "")
        arg = node.args[0]
        if (name in ("import_module", "__import__", "find_spec")
                and isinstance(arg, ast.Constant)
                and isinstance(arg.value, str)
                and arg.value.partition(".")[0] in refused):
            hits.append(arg.value)
    elif (isinstance(node, ast.Constant) and isinstance(node.value, str)
          and node.value.startswith("tetraear_tpu.")
          and all(p.isidentifier() for p in node.value.split("."))):
        hits.append(node.value)
    return hits


def test_no_source_of_the_port_names_the_reference():
    """No file of the port, and not chip_smoke.py, imports jax or the JAX
    package or names one of its modules as a string; the scan itself
    finds each form."""
    sources = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(sources) > 40
    for src in sources:
        tree = ast.parse(src.read_text(), filename=str(src))
        hits = [h for node in ast.walk(tree) for h in _names_reference(node)]
        assert not hits, (src, hits)
    probe = ast.parse("import jax.numpy\nfrom tetraear_tpu.ops import crc\n"
                      "importlib.import_module('tetraear_tpu')\n"
                      "m = 'tetraear_tpu.ops.crc'\n"
                      "ok = ('tetraear_tpu_torch.ops', 'tetraear_tpu/x.py:1')")
    found = [h for node in ast.walk(probe) for h in _names_reference(node)]
    assert found == ["jax.numpy", "tetraear_tpu.ops", "tetraear_tpu",
                     "tetraear_tpu.ops.crc"]


def test_hostref_is_gone():
    assert not (PORT / "hostref.py").exists()


# --- parity of the copies -------------------------------------------------

@pytest.mark.parametrize("seed", [0, 7, 123])
def test_synth_streams_and_symbols_equal(seed):
    for golden in (False, True):
        bits = tsynth.make_stream_bits(num_frames=3, seed=seed,
                                       golden=golden, payload=b"PARITY %d"
                                       % seed)
        np.testing.assert_array_equal(
            bits, jsynth.make_stream_bits(num_frames=3, seed=seed,
                                          golden=golden,
                                          payload=b"PARITY %d" % seed))
        sym = tsynth.bits_to_symbols(bits)
        np.testing.assert_array_equal(sym, jsynth.bits_to_symbols(bits))
        for mapping in ("pi4", "ref"):
            ph = tsynth.synthesize_symbol_phasors(sym, mapping, 0.3)
            np.testing.assert_array_equal(
                ph, jsynth.synthesize_symbol_phasors(sym, mapping, 0.3))
            np.testing.assert_array_equal(
                tsynth.upsample_hold(ph, 2.4e6),
                jsynth.upsample_hold(ph, 2.4e6))
    kw = dict(sample_rate=2.4e6, freq_offset_hz=850.0, snr_db=12.0,
              mapping="pi4", seed=seed)
    np.testing.assert_array_equal(tsynth.synthesize_iq(sym[:300], **kw),
                                  jsynth.synthesize_iq(sym[:300], **kw))
    for make in ("make_mac_end_frame_bits", "make_mac_block_bits"):
        np.testing.assert_array_equal(
            getattr(tsynth, make)(b"END %d" % seed, seed=seed),
            getattr(jsynth, make)(b"END %d" % seed, seed=seed))
    np.testing.assert_array_equal(
        tsynth.make_mac_resource_frame_bits(b"ENC", encrypted=True,
                                            seed=seed),
        jsynth.make_mac_resource_frame_bits(b"ENC", encrypted=True,
                                            seed=seed))
    np.testing.assert_array_equal(tsynth.make_test_speech(0.25, seed=seed),
                                  jsynth.make_test_speech(0.25, seed=seed))


def _pdu(p):
    """A MacPDU as plain values (the two packages' enums are different
    classes)."""
    if p is None:
        return None
    d = dataclasses.asdict(p)
    d["pdu_type"] = p.pdu_type.name
    return d


def _corpus():
    """MAC blocks of every PDU type and encryption mode, carrying clear
    texts, SDS-shaped and LIP-shaped payloads and random bytes, and golden
    MAC-RESOURCE / MAC-END slots (the fragment path)."""
    r = np.random.default_rng(0xC0)
    payloads = [b"HELLO HELLO", b"", b"\x02\x01HI THERE", b"\x82\x04\x01TXT",
                b"\x0a\x48\x12\x34\x56\x78\x9a\xbc", b"\x03" + bytes(10),
                b"\x09\x00\x41\x42\x43", b"\x0c\x01\x02"]
    payloads += [r.integers(0, 256, int(r.integers(1, 21))).astype(np.uint8)
                 .tobytes()
                 for _ in range(24)]
    blocks = []
    for i, payload in enumerate(payloads):
        block = tsynth.make_mac_block_bits(payload, address=0x100 + i,
                                           seed=i, encryption_mode=i % 4)
        blocks.append(block)
        for pdu_type in (1, 2, 3):
            b = block.copy()
            b[0], b[1] = pdu_type >> 1, pdu_type & 1
            blocks.append(b)
    for i in range(4):
        blocks.append(tsynth.make_mac_resource_frame_bits(b"FRAG %d" % i,
                                                          seed=i))
        blocks.append(tsynth.make_mac_end_frame_bits(b"END %d" % i, seed=i))
    return payloads, blocks


def test_parser_decodes_the_corpus_like_the_reference():
    payloads, blocks = _corpus()
    mine, ref = tparser.TetraProtocolParser(), jparser.TetraProtocolParser()
    for bits in blocks:
        a, b = mine.parse_mac_pdu(bits), ref.parse_mac_pdu(bits)
        assert _pdu(a) == _pdu(b)
        if a is None:
            continue
        assert mine.parse_sds_message(a) == ref.parse_sds_message(b)
        ma, mb = mine.parse_call_metadata(a), ref.parse_call_metadata(b)
        assert (ma is None) == (mb is None)
        if ma is not None:
            assert dataclasses.asdict(ma) == dataclasses.asdict(mb)
            assert (mine.format_call_metadata(ma)
                    == ref.format_call_metadata(mb))
        assert mine.extract_voice_payload(a) == ref.extract_voice_payload(b)
    for data in payloads:
        assert mine.parse_sds_data(data) == ref.parse_sds_data(data)
        assert mine.parse_lip(data) == ref.parse_lip(data)
    assert mine.get_statistics() == ref.get_statistics()


KEYS = {"TEA1": bytes(range(1, 11)),
        "TEA2": bytes(range(16, 32)),
        "TEA3": bytes(range(0xF0, 0x100)),
        "TEA4": bytes.fromhex("00112233445566778899aabbccddeeff")}


@pytest.mark.parametrize("alg", sorted(KEYS))
def test_tea_keystreams_and_decryptions_equal(alg):
    """Encrypting zeros (the keystream), random data in ECB and CBC, and
    decrypting it back: the port's TEA gives the reference's bytes."""
    key = KEYS[alg]
    data = bytes(np.random.default_rng(len(alg) + key[0]).integers(
        0, 256, 64, dtype=np.uint8))
    iv = bytes(range(8))
    for plain in (bytes(64), data):
        for kw in ({}, {"iv": iv}):
            ct = ttea.TEAEncryptor(key, alg).encrypt(plain, **kw)
            assert ct == jtea.TEAEncryptor(key, alg).encrypt(plain, **kw)
            pt = ttea.TEADecryptor(key, alg).decrypt(ct, **kw)
            assert pt == jtea.TEADecryptor(key, alg).decrypt(ct, **kw)
            assert pt == plain
    assert (ttea.TEADecryptor(key, alg).decrypt(data)
            == jtea.TEADecryptor(key, alg).decrypt(data))


def test_native_tea_and_crc_engines_match():
    """The native engines the port builds into build/native/ give the
    reference's brute-force plaintexts and the numpy CRC verdicts; with
    no compiler both sides return None."""
    pairs = [(k, a) for a, ks in COMMON_KEYS.items() for k in ks][:12]
    pairs.append((bytes(3), "TEA2"))           # a bad length: None in place
    data = bytes(range(48))
    assert tnative.bruteforce(pairs, data) == jnative.bruteforce(pairs, data)
    r = np.random.default_rng(3)
    for _ in range(40):
        bits = r.integers(0, 2, int(r.integers(10, 300))).astype(np.uint8)
        assert (tcrc.soft_crc_check_host(bits)
                == tcrc.soft_crc_check_numpy(bits))


def _encrypted_stream(seed: int) -> np.ndarray:
    """Golden slots whose payload is TEA-encrypted under a common key."""
    alg, keys = next(iter(COMMON_KEYS.items()))
    payload = ttea.TEAEncryptor(keys[0], alg).encrypt(b"SECRET!!")
    lead = np.random.default_rng(seed).integers(0, 2, 64).astype(np.uint8)
    frames = [tsynth.make_mac_resource_frame_bits(payload, encrypted=True,
                                                  seed=seed + k)
              for k in range(3)]
    return np.concatenate([lead] + frames)


@pytest.mark.parametrize("case", ["clear", "noisy", "encrypted"])
def test_decoder_frames_equal_the_reference(case):
    """TetraDecoder.decode on planted streams (clear golden slots, the
    same with bit errors, encrypted slots with the decrypt search on):
    the port's frames are the reference's, key for key."""
    if case == "encrypted":
        bits = _encrypted_stream(5)
    else:
        bits = tsynth.make_stream_bits(num_frames=4, seed=11, golden=True,
                                       payload=b"DECODE ME")
        if case == "noisy":
            flip = np.random.default_rng(2).random(bits.size) < 0.01
            bits = bits ^ flip.astype(np.uint8)
    symbols = tsynth.bits_to_symbols(bits)
    auto = case == "encrypted"
    mine = TetraDecoder(auto_decrypt=auto, device="cpu").decode(symbols)
    ref = JaxDecoder(auto_decrypt=auto).decode(symbols)
    assert len(mine) == len(ref) > 0
    dump = [json.dumps(jrec.sanitize_frame(f), sort_keys=True) for f in ref]
    assert [json.dumps(trec.sanitize_frame(f), sort_keys=True)
            for f in mine] == dump


@pytest.mark.parametrize("suffix", [".cf32", ".sc16", ".cs8", ".npy"])
def test_file_replay_chunks_equal(tmp_path, suffix):
    """FileReplaySource reads the same chunks (the last one short) from
    every format, and loops the same way."""
    x = tsynth.planted_single()[0][:50_000] * 0.5
    path = tmp_path / f"iq{suffix}"
    jreplay.save_iq(path, x, sample_rate=2.4e6, center_frequency=391e6)
    for loop in (False, True):
        a = treplay.FileReplaySource(path, loop=loop)
        b = jreplay.FileReplaySource(path, loop=loop)
        assert a.open() and b.open()
        assert (a.sample_rate, a.frequency) == (b.sample_rate, b.frequency)
        for _ in range(5 if loop else 10):
            ca, cb = a.read_samples(12_345), b.read_samples(12_345)
            np.testing.assert_array_equal(ca, cb)
            assert a.exhausted == b.exhausted
            if a.exhausted:
                break
        a.close()
        b.close()


@pytest.mark.parametrize("include_bits", [True, False])
def test_jsonl_recorder_bytes_equal(tmp_path, include_bits):
    """JsonlFrameRecorder writes the reference's bytes for the same
    decoded frames (numpy values, bytes, nested dicts included)."""
    bits = tsynth.make_stream_bits(num_frames=3, seed=4, golden=True)
    frames = JaxDecoder(auto_decrypt=False).decode(
        tsynth.bits_to_symbols(bits))
    frames.append({"bits": np.arange(6, dtype=np.uint8),
                   "raw": b"\x00\xff", "nested": {"x": np.float32(1.5)},
                   "text": "ÄÖ"})
    paths = {}
    for name, rec in (("port", trec), ("ref", jrec)):
        paths[name] = tmp_path / f"{name}.jsonl"
        with rec.JsonlFrameRecorder(paths[name],
                                    include_bits=include_bits) as r:
            for f in frames:
                r.write(f)
    assert paths["port"].read_bytes() == paths["ref"].read_bytes()


def _log_run(module, pkg: str, log_dir: Path, verbose: bool) -> dict:
    """setup_logging of `module` into log_dir, one record per routed
    logger of package `pkg` and one foreign record, then the files it
    wrote as {name with the run id cut: lines with the time and the
    package name cut}, and the console handler's level."""
    import logging
    root = logging.getLogger()
    saved = root.handlers[:], root.level
    try:
        files = module.setup_logging(verbose=verbose, log_dir=log_dir)
        console = [h.level for h in root.handlers
                   if type(h) is logging.StreamHandler]
        for name in ("ui.cli", "signal.x", "io.replay", "models.m",
                     "core.decoder", "protocol.parser", "crypto.tea",
                     "codec.run", "recording.r", "audio.blocks", "frames"):
            for level in (logging.DEBUG, logging.INFO):
                logging.getLogger(f"{pkg}.{name}").log(level, "%s %d",
                                                       name, level)
        logging.getLogger("elsewhere").warning("foreign")
    finally:
        for h in root.handlers:
            h.close()
        root.handlers[:] = saved[0]
        root.setLevel(saved[1])
    run_id = files["all"].stem.removeprefix("tetraear_tpu_")
    written = {}
    for path in sorted(log_dir.iterdir()):
        lines = [line.split(" ", 2)[2].replace(pkg + ".", "PKG.")
                 for line in path.read_text().splitlines()]
        written[path.name.replace(run_id, "RUN")] = lines
    assert {p.name for p in files.values()} >= {p.name
                                                for p in log_dir.iterdir()}
    return {"files": written, "console": console}


@pytest.mark.parametrize("verbose", [False, True])
def test_logging_setup_routes_like_the_reference(tmp_path, monkeypatch,
                                                 verbose):
    """The port's copy of ui/logging_setup: the same six per-run files,
    each record of the port's package routed to the file the reference
    routes its own package's record of the same name to, the same
    console level for -v, and the same directories from the same
    environment overrides."""
    from tetraear_tpu.ui import logging_setup as jlog
    from tetraear_tpu_torch.ui import logging_setup as tlog
    mine = _log_run(tlog, "tetraear_tpu_torch", tmp_path / "port", verbose)
    ref = _log_run(jlog, "tetraear_tpu", tmp_path / "ref", verbose)
    assert mine == ref
    assert len(mine["files"]) == 6
    for var in ("TETRAEAR_TPU_LOG_DIR", "TETRAEAR_TPU_DATA_DIR",
                "TETRAEAR_TPU_RECORDS_DIR"):
        monkeypatch.setenv(var, str(tmp_path / var))
    for fn in ("get_log_dir", "get_user_data_dir", "get_records_dir"):
        assert getattr(tlog, fn)() == getattr(jlog, fn)()


# --- the downlink / uplink host copies -------------------------------------

def _pkgs():
    """The reference's and the port's host modules of the downlink and
    uplink, as two namespaces with the same names."""
    import types
    out = {}
    for name, root in (("ref", "tetraear_tpu"), ("port", "tetraear_tpu_torch")):
        import importlib
        mods = {m.rpartition(".")[2]: importlib.import_module(f"{root}.{m}")
                for m in ("protocol.bursts", "protocol.cmce",
                          "protocol.layer3", "protocol.mac", "protocol.mle",
                          "protocol.mm", "protocol.pdus", "protocol.sds_tl",
                          "core.calls", "audio.blocks", "audio.voice")}
        out[name] = types.SimpleNamespace(**mods)
    return out["ref"], out["port"]


def _plain(obj):
    """Dataclasses, arrays and containers as plain comparable values, with
    a class's name in place of the class (the two packages' classes
    differ)."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return (type(obj).__name__,
                {f.name: _plain(getattr(obj, f.name))
                 for f in dataclasses.fields(obj)})
    if isinstance(obj, np.ndarray):
        return ("array", obj.dtype.str, obj.tolist())
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_plain(v) for v in obj]
    if isinstance(obj, np.generic):
        return obj.item()
    return obj


def _l3_pdus(p) -> list:
    """Every CMCE / MM PDU class of the package with its default fields,
    and the downlink / uplink simulations' own PDUs, as (pd, pdu,
    uplink)."""
    A = p.cmce.Address
    pdus = [(p.mle.PD.CMCE, cls(), False)
            for cls in p.cmce._DOWNLINK_REGISTRY.values()]
    pdus += [(p.mle.PD.CMCE, cls(), True)
             for cls in p.cmce._UPLINK_REGISTRY.values()]
    pdus += [(p.mle.PD.MM, cls(), False) for cls in p.mm._REGISTRY.values()]
    text = p.sds_tl.build_text_transfer("PARITY via SDS-TL")
    pdus += [
        (p.mle.PD.CMCE, p.cmce.DSetup(call_identifier=41, call_priority=5,
                                      transmission_grant=1,
                                      calling_party=A(1, 0x457)), False),
        (p.mle.PD.CMCE, p.cmce.DTxGranted(
            call_identifier=41, transmission_grant=1,
            transmitting_party=A(1, 0x457)), False),
        (p.mle.PD.CMCE, p.cmce.DSdsData(calling_party=A(1, 0x457),
                                        short_data_type=3,
                                        data_bits=text), False),
        (p.mle.PD.CMCE, p.cmce.DRelease(call_identifier=41,
                                        disconnect_cause=2), False),
        (p.mle.PD.CMCE, p.cmce.USetup(basic_service_info=0, call_priority=5,
                                      called_party=A(1, 0x2328)), True),
        (p.mle.PD.CMCE, p.cmce.USdsData(called_party=A(0, 0x2A),
                                        short_data_type=0,
                                        user_data=0xBEEF), True),
        (p.mle.PD.MM, p.mm.DLocationUpdateAccept(
            location_update_accept_type=2, ssi=808), False)]
    grp = p.mm.DAttachDetachGroupIdentity(group_identity_ack_request=1)
    grp.set_groups([p.mm.GroupIdentity(gssi=9001, attach=True, lifetime=2),
                    p.mm.GroupIdentity(gssi=9002, attach=False,
                                       detach_reason=1)])
    pdus.append((p.mle.PD.MM, grp, False))
    nb = p.mle.DNwrkBroadcast(
        cell_reselect_parameters=0xABCD, cell_load_ca=2,
        neighbours=[p.mle.NeighbourCell(cell_identifier=3, main_carrier=3610,
                                        la_flag=1, location_area=77),
                    p.mle.NeighbourCell(cell_identifier=4, main_carrier=3620,
                                        extended_flag=1, frequency_band=4)])
    pdus.append((p.mle.PD.MLE, nb, False))
    return pdus


def test_layer3_copies_build_and_route_like_the_reference():
    """Every CMCE and MM PDU type, the simulations' PDUs, MM group
    attachment and MLE D-NWRK-BROADCAST: the port's copies build the
    reference's bits, wrap them into the same MAC-RESOURCE / MAC-ACCESS /
    MAC-DATA blocks (fragmented across MAC-FRAG / MAC-END where long), and
    route them back through layer3 to the same results and descriptions."""
    ref, port = _pkgs()
    pairs = list(zip(_l3_pdus(ref), _l3_pdus(port)))
    assert len(pairs) > 30
    for (pd, a, up), (pd2, b, up2) in pairs:
        assert (pd, up) == (pd2, up2) and type(a).__name__ == type(b).__name__
        np.testing.assert_array_equal(a.build(), b.build())
        tm_a, tm_b = ref.mle.wrap_mle(pd, a.build()), port.mle.wrap_mle(
            pd, b.build())
        np.testing.assert_array_equal(tm_a, tm_b)
        if up:
            blocks = []
            for cls, addr, k1, ch in (("MacAccess", 0xABCD, 92, "SCH/HU"),
                                      ("MacUplinkData", 0x777, 268,
                                       "SCH/F")):
                built = []
                for pkg, tm in ((ref, tm_a), (port, tm_b)):
                    try:
                        built.append(getattr(pkg.mac, cls)(
                            address=addr, tm_sdu=tm).build(k1))
                    except AssertionError:      # the PDU exceeds the block
                        built.append(None)
                assert (built[0] is None) == (built[1] is None)
                if built[0] is not None:
                    blocks.append((*built, ch))
            assert blocks
            for ba, bb, ch in blocks:
                np.testing.assert_array_equal(ba, bb)
                ra = ref.layer3.decode_uplink_block(ba, ch)
                rb = port.layer3.decode_uplink_block(bb, ch)
                assert _plain(ra) == _plain(rb)
                assert ([ref.layer3.describe_pdu(r) for r in ra]
                        == [port.layer3.describe_pdu(r) for r in rb])
            continue
        fa = [blk for _, blk in ref.mac.fragment_tm_sdu(
            tm_a, 268, ref.mac.MacResource(address=0x2328))]
        fb = [blk for _, blk in port.mac.fragment_tm_sdu(
            tm_b, 268, port.mac.MacResource(address=0x2328))]
        assert len(fa) == len(fb)
        da, db = ref.layer3.Defragmenter(), port.layer3.Defragmenter()
        for ba, bb in zip(fa, fb):
            np.testing.assert_array_equal(ba, bb)
            ra, rb = (ref.layer3.decode_mac_block(ba),
                      port.layer3.decode_mac_block(bb))
            assert _plain(ra) == _plain(rb)
            assert ([ref.layer3.describe_pdu(r) for r in ra]
                    == [port.layer3.describe_pdu(r) for r in rb])
            for x, y in zip(ra, rb):
                if x.fragment:
                    assert _plain(da.feed(x)) == _plain(db.feed(y))


def test_burst_and_pdu_copies_equal_the_reference():
    """The burst builders, slicers and field maps, and the SYNC / SYSINFO
    / ACCESS-ASSIGN PDUs, on seeded bits."""
    ref, port = _pkgs()
    r = np.random.default_rng(5)
    for name in ("STS", "NTS1", "NTS2", "ETS", "SB_FIELDS", "NDB_FIELDS",
                 "NUB_FIELDS", "CB_FIELDS", "MIDAMBLE_POS", "NUB_BITS",
                 "CB_BITS"):
        assert _plain(getattr(ref.bursts, name)) == _plain(
            getattr(port.bursts, name)), name
    bits = lambda n: r.integers(0, 2, n).astype(np.uint8)  # noqa: E731
    for _ in range(4):
        args = {"ndb": (bits(216), bits(30), bits(216)),
                "sb": (bits(120), bits(30), bits(216)),
                "nub": (bits(216), bits(216)), "cb": (bits(168),)}
        for kind, a in args.items():
            for training in ((1, 2) if kind in ("ndb", "nub") else (None,)):
                kw = {} if training is None else {"training": training}
                x = getattr(ref.bursts, f"build_{kind}")(*a, **kw)
                y = getattr(port.bursts, f"build_{kind}")(*a, **kw)
                np.testing.assert_array_equal(x, y)
                if kind in ("ndb", "sb"):
                    assert (ref.bursts.classify_burst(x)
                            == port.bursts.classify_burst(y))
                    assert (_plain(ref.bursts.slice_burst(x)._asdict())
                            == _plain(port.bursts.slice_burst(y)._asdict()))
                else:
                    sl = f"slice_{kind}"
                    assert (_plain(getattr(ref.bursts, sl)(x))
                            == _plain(getattr(port.bursts, sl)(y)))
    for cls, kw in (("SyncPDU", dict(colour_code=17, timeslot=2,
                                     frame_number=18, multiframe_number=60,
                                     mcc=262, mnc=1001)),
                    ("SysinfoPDU", dict(main_carrier=3600, frequency_band=3,
                                        location_area=999)),
                    ("AccessAssignPDU", dict(header=3, field1=17,
                                             field2=0))):
        a, b = (getattr(ref.pdus, cls)(**kw), getattr(port.pdus, cls)(**kw))
        np.testing.assert_array_equal(a.build(), b.build())
        assert _plain(getattr(ref.pdus, cls).parse(a.build())) == _plain(
            getattr(port.pdus, cls).parse(b.build()))
    for _ in range(20):
        b14 = bits(14)
        a, b = (ref.pdus.AccessAssignPDU.parse(b14),
                port.pdus.AccessAssignPDU.parse(b14))
        assert _plain(a) == _plain(b) and a.downlink_usage == b.downlink_usage


def test_call_tracker_copy_follows_the_reference():
    """The call ledger through a group call's lifecycle, an SDS and a
    second call: the same metadata after every PDU, the same ledger."""
    ref, port = _pkgs()
    ta, tb = ref.calls.CallTracker(), port.calls.CallTracker()
    for (pd, a, up), (_, b, _) in zip(_l3_pdus(ref), _l3_pdus(port)):
        if up or pd != ref.mle.PD.CMCE:
            continue
        ma = ta.update(a, mac_address=9000)
        mb = tb.update(b, mac_address=9000)
        assert _plain(ma) == _plain(mb)
        for tn in (1, 2, 3, 4):
            assert _plain(ta.call_for_tn(tn)) == _plain(tb.call_for_tn(tn))
    assert _plain(ta.calls) == _plain(tb.calls)
    assert _plain(ta.released) == _plain(tb.released)


def test_codec_copies_build_into_build_codec_and_equal_the_reference():
    """The port builds native/codec into build/codec/ (nothing written
    into native/codec) and its encoder and decoder give the reference's
    committed executables' bits and PCM on synthesized speech; the codec
    block builders give the reference's bytes."""
    ref, port = _pkgs()
    before = sorted(p.name for p in (REPO / "native" / "codec").iterdir())
    enc, jenc = port.voice.VoiceEncoder(), ref.voice.VoiceEncoder()
    assert sorted(p.name for p in (REPO / "native" / "codec").iterdir()) \
        == before
    if not enc.working:
        pytest.skip("no C compiler: the port's codec is not built")
    assert enc.scoder_path.parent.parent == REPO / "build" / "codec"
    speech = tsynth.make_test_speech(0.4, seed=3)
    np.testing.assert_array_equal(enc.encode_pcm_bits(speech),
                                  jenc.encode_pcm_bits(speech))
    blocks = enc.encode_pcm(speech)
    assert len(blocks) >= 5
    np.testing.assert_array_equal(port.voice.VoiceProcessor().decode_stream(
        blocks), ref.voice.VoiceProcessor().decode_stream(blocks))
    r = np.random.default_rng(9)
    llrs = np.clip(r.standard_normal(432), -1, 1).astype(np.float32)
    hard = r.integers(0, 2, 432).astype(np.uint8)
    assert (port.blocks.block_from_soft_llrs(llrs)
            == ref.blocks.block_from_soft_llrs(llrs))
    assert (port.blocks.block_from_hard_bits(hard)
            == ref.blocks.block_from_hard_bits(hard))
    for b in blocks[:3]:
        assert port.blocks.validate_block(b) and ref.blocks.validate_block(b)
        np.testing.assert_array_equal(port.blocks.bits_from_tet_block(b),
                                      ref.blocks.bits_from_tet_block(b))


# --- the receive loop's, the scanner's and the operator's host copies ------

# the port's copies of host modules the JAX package keeps at the same
# path; each is the reference's code with only the package name mapped
# (and its docstrings its own)
HOST_COPIES = ("core/validator", "core/mcc_mnc", "core/location",
               "ui/session", "ui/settings", "ui/text", "ui/waterfall",
               "io/frames_query", "io/capture", "audio/accumulator",
               "audio/export", "audio/playback", "utils/textscore")


class _Normalized(ast.NodeTransformer):
    """An AST without docstrings, the port's package name mapped back to
    the reference's in imports and string constants."""

    @staticmethod
    def _name(text):
        return text.replace("tetraear_tpu_torch", "tetraear_tpu")

    def _strip(self, node):
        body = getattr(node, "body", None)
        if (body and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            node.body = body[1:] or [ast.Pass()]
        return self.generic_visit(node)

    visit_Module = visit_ClassDef = visit_FunctionDef = _strip

    def visit_ImportFrom(self, node):
        if node.module:
            node.module = self._name(node.module)
        return node

    def visit_Constant(self, node):
        if isinstance(node.value, str):
            node.value = self._name(node.value)
        return node


def _code(path: Path) -> str:
    tree = _Normalized().visit(ast.parse(path.read_text()))
    return ast.dump(tree, include_attributes=False)


@pytest.mark.parametrize("name", HOST_COPIES)
def test_host_copy_is_the_reference_code(name):
    """Every new host copy is the reference module's code: the same AST
    once docstrings are dropped and the package name is mapped."""
    assert _code(PORT / f"{name}.py") == _code(
        REPO / "tetraear_tpu" / f"{name}.py")


def test_throughput_meter_is_the_reference_code():
    """utils/metrics: ThroughputMeter is the reference's class (its
    profile_trace wraps torch.profiler instead of jax.profiler)."""
    def meter(path):
        tree = _Normalized().visit(ast.parse(path.read_text()))
        cls = next(n for n in tree.body if isinstance(n, ast.ClassDef)
                   and n.name == "ThroughputMeter")
        return ast.dump(cls)
    assert meter(PORT / "utils" / "metrics.py") == meter(
        REPO / "tetraear_tpu" / "utils" / "metrics.py")


def test_host_copies_compute_like_the_reference(tmp_path):
    """The copies that compute, on the same inputs: the frame validator,
    the MCC table, the location parser, the text scores, the voice
    accumulator, the WAV export, and the waterfall's buffer, colormap,
    PNG, calibration, peak helpers and status machine."""
    import importlib
    mods = {}
    for pkg in ("tetraear_tpu", "tetraear_tpu_torch"):
        mods[pkg] = {n: importlib.import_module(f"{pkg}.{n.replace('/', '.')}")
                     for n in HOST_COPIES}
    ref, port = mods["tetraear_tpu"], mods["tetraear_tpu_torch"]

    frames = [json.loads(line) for line in (
        REPO / "tests" / "conformance" / "fixtures"
        / "long_mixed.golden.jsonl").read_text().splitlines()
        if "__meta__" not in line]
    frames += [{"type_name": "MAC-RESOURCE", "crc_ok": False,
                "call_metadata": {"mcc": m, "mnc": n},
                "encryption_algorithm": alg, "decrypted": True,
                "decrypt_confidence": c}
               for m, n, alg, c in ((260, 1, "TEA1", 200), (262, 1001,
                                                            "TEA9", 90),
                                    (901, 7, None, 0), (214, 3, "TEA3", 180))]
    va = ref["core/validator"].TetraSignalValidator(expected_country_mcc=260)
    vb = port["core/validator"].TetraSignalValidator(expected_country_mcc=260)
    for f in frames:
        assert va.validate_frame(dict(f)) == vb.validate_frame(dict(f))
    assert va.get_statistics() == vb.get_statistics()
    for mcc, mnc in (("260", "01"), ("262", None), ("999", "1"), ("", None)):
        for fn in ("get_country_from_mcc", "get_location_info"):
            args = (mcc,) if fn == "get_country_from_mcc" else (mcc, mnc)
            assert (getattr(ref["core/mcc_mnc"], fn)(*args)
                    == getattr(port["core/mcc_mnc"], fn)(*args))
    la, lb = ref["core/location"].LocationParser, \
        port["core/location"].LocationParser
    texts = ["Lat: 52.2297 Lon: 21.0122", "52.2297N 21.0122E", "no fix",
             "[LIP] pos 50.06,19.94", "GPS 48°51'N 2°21'E"]
    for t in texts:
        assert la.parse_coordinates(t) == lb.parse_coordinates(t)
    for data in (bytes(range(12)), b"\x0a\x48\x12\x34\x56\x78\x9a\xbc", b""):
        assert la.parse_lip_message(data) == lb.parse_lip_message(data)
    for f in frames[:20] + [{"decoded_text": t} for t in texts]:
        assert (la.extract_location_from_frame(f)
                == lb.extract_location_from_frame(f))
    assert la.format_coordinates(52.2, -21.0) == lb.format_coordinates(
        52.2, -21.0)
    for t in ["", "HELLO WORLD again", "[TXT] Meet me at 10", "\x80\x81abc",
              "[GSM7] AAAA@@@@@", "lowercase and spaces"]:
        for fn in ("is_pure_ascii", "score_text", "score_readability"):
            assert (getattr(ref["utils/textscore"], fn)(t)
                    == getattr(port["utils/textscore"], fn)(t))

    class Clock:
        t = 0.0

        def __call__(self):
            return self.t
    clips = []
    r = np.random.default_rng(4)
    pcm = [r.standard_normal(int(n)).astype(np.float32)
           for n in r.integers(400, 9000, 30)]
    for mod in (ref, port):
        clock = Clock()
        acc = mod["audio/accumulator"].VoiceAccumulator(clock=clock)
        out = []
        for k, a in enumerate(pcm):
            clock.t += 0.5 if k % 7 else 4.0
            out.append(acc.add(k % 3, a))
        out += acc.finalize_all()
        clips.append(out)
    assert len(clips[0]) == len(clips[1])
    for a, b in zip(*clips):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)
    for name, mod in (("ref", ref), ("port", port)):
        mod["audio/export"].write_wav(tmp_path / f"{name}.wav", pcm[0] * 0.3)
    assert (tmp_path / "ref.wav").read_bytes() == (
        tmp_path / "port.wav").read_bytes()

    wa, wb = ref["ui/waterfall"], port["ui/waterfall"]
    freqs = np.linspace(391.9, 392.1, 512)
    rows = [-90 + 60 * np.exp(-((freqs - 392.0 - 0.003 * k) / 0.004) ** 2)
            + r.standard_normal(512) for k in range(40)]
    ba, bb = wa.WaterfallBuffer(history=32), wb.WaterfallBuffer(history=32)
    for row in rows:
        ba.update_spectrum(freqs, row)
        bb.update_spectrum(freqs, row)
    np.testing.assert_array_equal(ba.as_array(), bb.as_array())
    img = wb.render_waterfall_rgb(bb, -95, -25)
    np.testing.assert_array_equal(wa.render_waterfall_rgb(ba, -95, -25), img)
    wa.save_png(tmp_path / "a.png", img)
    wb.save_png(tmp_path / "b.png", img)
    assert (tmp_path / "a.png").read_bytes() == (
        tmp_path / "b.png").read_bytes()
    for row in rows[:5]:
        assert (wa.find_spike_band(freqs, row, 392.0, 50e3)
                == wb.find_spike_band(freqs, row, 392.0, 50e3))
        assert (wa.find_peak_near(freqs, row, 392.01)
                == wb.find_peak_near(freqs, row, 392.01))
        assert (wa.follow_frequency_step(freqs, row, 392.004)
                == wb.follow_frequency_step(freqs, row, 392.004))
        assert (wa.AutoSpectrumCalibration(clock=lambda: 10.0).compute(
            freqs * 1e6, row) == wb.AutoSpectrumCalibration(
            clock=lambda: 10.0).compute(freqs * 1e6, row))
    statuses = []
    for mod in (wa, wb):
        clock = Clock()
        m = mod.TetraStatusMachine(clock=clock)
        m.on_signal(True)
        seen = []
        for f in frames:
            clock.t += 0.7
            m.on_frame(f)
            seen.append(m.status())
        statuses.append(seen)
    assert statuses[0] == statuses[1]


def test_operator_commands_run_with_the_reference_refused(tmp_path):
    """With jax and tetraear_tpu refused by an import hook: the new
    modules import, and `listen` (replay, -o, --waterfall), `scan` (stepped
    and --wideband, its hot channels validated), `waterfall`, `frames`
    and a headless `tui` run on --device cpu and find the planted
    texts."""
    x1, text1 = tsynth.planted_single("ref-compat", num_frames=8)
    xs, want = tsynth.planted_scan()
    single, scan = tmp_path / "single.cf32", tmp_path / "scan.cf32"
    treplay.save_iq(single, x1)
    treplay.save_iq(scan, xs)
    tetra_mhz = sorted(round((392.5e6 + off) / 1e6, 3) for off in want)
    out = _guarded(f'''
import contextlib, importlib, io, json, os
os.environ["TETRAEAR_TPU_LOG_DIR"] = {str(tmp_path / "logs")!r}
from tetraear_tpu_torch.ui.cli import main
for name in ("signal.detector", "signal.scanner", "ui.capture_loop",
             "ui.waterfall", "ui.session", "ui.settings", "ui.text",
             "ui.tui", "core.validator", "core.mcc_mnc", "core.location",
             "io.capture", "io.frames_query", "audio.accumulator",
             "audio.export", "audio.playback", "utils.metrics",
             "utils.textscore"):
    importlib.import_module("tetraear_tpu_torch." + name)

def run(*argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main([*argv]) == 0, argv
    return buf.getvalue()

log = {str(tmp_path / "l.jsonl")!r}
text = run("listen", "--iq-file", {str(single)!r}, "--no-afc",
           "--no-auto-decrypt", "--device", "cpu", "-o", log,
           "--waterfall", {str(tmp_path / "wf.ppm")!r})
rows = [json.loads(line) for line in open(log)]
assert rows and {{r["sds_message"] for r in rows}} == {{{text1!r}}}, rows
text = run("scan", "391.4", "393.6", "--iq-file", {str(scan)!r}, "-f",
           "392.5", "--wideband", "--device", "cpu")
tagged = sorted(float(line.split()[0]) for line in text.splitlines()
                if line.endswith("*** TETRA"))
assert tagged == {tetra_mhz!r}, text
text = run("scan", "392.475", "392.525", "--iq-file", {str(scan)!r}, "-f",
           "392.5", "--device", "cpu")
assert "*** TETRA" in text, text
text = run("waterfall", {str(scan)!r}, "-o", {str(tmp_path / "wf.png")!r},
           "--device", "cpu")
assert "[OK] 2048x200 waterfall" in text, text
text = run("frames", log, "--stats")
assert "frames=" + str(len(rows)) + " crc_pass=" in text, text
text = run("tui", "--iq-file", {str(single)!r}, "--no-afc",
           "--max-chunks", "3", "--device", "cpu")
assert "Frames: " in text and "HELLO HELLO" in text, text[-500:]
bad = [m for m in sys.modules if m.partition(".")[0] in REFUSED]
assert not bad, bad
print("ran")
''')
    assert "ran" in out
