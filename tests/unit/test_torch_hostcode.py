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
    of the port imports, and `python -m tetraear_tpu_torch decode ...
    --device cpu` decodes a planted single-carrier capture and a planted
    16-carrier capture (--conv s2d), each finding its text."""
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
bad = [m for m in sys.modules if m.partition(".")[0] in REFUSED]
assert not bad, bad
print("decoded")
''')
    assert "decoded" in out
    assert int(out.split("imported ")[1].split()[0]) >= 40


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
