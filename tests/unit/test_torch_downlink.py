"""The port's ETSI downlink (models/downlink.py and what it runs: the
RM(30,14) AACH code, the TCH coding, the spectrum and offset estimates,
the multicarrier front and the cell survey) against the JAX package, on
the CPU.

Inputs are made with numpy from fixed seeds (the transmitters are host
code, and the port's copies are held equal to the reference's here) and
go through both packages.  Decisions must be identical: slot kinds,
TN/FN/MN, channels, CRC verdicts, AACH usage, SDS texts, layer-3
descriptions, call metadata, voice blocks.  Float stages are held within
stated tolerances: the AACH margins within 1e-5 x max|score| (f32 sums
in another order), spectra within 1e-3 dB on bins within 60 dB of the
peak and 0.05 dB on every bin (FFT rounding, an absolute error that
grows in dB as a bin's power falls), the
offset estimates within 1 Hz, traffic soft values within 1e-4 (the
demodulators' f32 rounding; 1e-3 behind the multicarrier channelizer,
whose f32 mixer and FIR sums run in another order) and the AACH margins
of received captures within 60 times that (two scores of 30 soft
values)."""

import dataclasses
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from tetraear_tpu.models import downlink as jdl
from tetraear_tpu.ops import channel_coding as jcc
from tetraear_tpu.ops import channelizer as jch
from tetraear_tpu.ops import fused as jfused
from tetraear_tpu.ops import rm3014 as jrm
from tetraear_tpu.ops import spectrum as jsp
from tetraear_tpu.ui import cli as jax_cli

from tetraear_tpu_torch.models import downlink as tdl
from tetraear_tpu_torch.ops import channel_coding as tcc
from tetraear_tpu_torch.ops import channelizer as tch
from tetraear_tpu_torch.ops import fir as tfir
from tetraear_tpu_torch.ops import fused as tfused
from tetraear_tpu_torch.ops import rm3014 as trm
from tetraear_tpu_torch.ops import spectrum as tsp
from tetraear_tpu_torch.ui import cli
from tetraear_tpu_torch.utils import synth as tsynth

CPU = torch.device("cpu")
MARGIN_TOL = 1e-5       # x max|score|
DB_TOL = 1e-3           # dB, bins within 60 dB of the peak
DB_TOL_ALL = 0.05       # dB, every bin
HZ_TOL = 1.0
LLR_TOL = 1e-4
LLR_TOL_MC = 1e-3


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


def _plain(obj):
    """Dataclasses, arrays, bytes and containers as plain JSON-able
    values (the two packages' classes differ)."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: _plain(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, (bytes, bytearray)):
        return bytes(obj).hex()
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_plain(v) for v in obj]
    if isinstance(obj, np.generic):
        return obj.item()
    return obj


def _decisions(frames, layer3) -> list:
    """Every decision of each decoded slot: the frame dict of the host
    schema (TDMA coordinates, channel, CRC, AACH usage, SDS, layer 3,
    call metadata, crypto outcome) plus the MAC bits, the AACH PDU, the
    SYNC / SYSINFO PDUs, the traffic bits and the voice block."""
    out = []
    for f in frames:
        d = _plain(f.to_frame_dict())
        d.update(aach=_plain(f.aach), sync=_plain(f.sync_pdu),
                 sysinfo=_plain(f.sysinfo), mac_bits=_plain(f.mac_bits),
                 tch_bits=_plain(f.tch_bits), voice=_plain(f.voice_block),
                 stolen=f.stolen, decrypted_data=_plain(f.decrypted_data),
                 layer3_all=[layer3.describe_pdu(r) for r in f.layer3 or []])
        out.append(json.loads(json.dumps(d)))
    return out


def _same_frames(mine, ref, llr_tol: float = LLR_TOL) -> None:
    """Equal decisions; soft traffic values within llr_tol and AACH
    margins within 60 x llr_tol (two scores of 30 soft values each)."""
    from tetraear_tpu.protocol import layer3 as jl3
    from tetraear_tpu_torch.protocol import layer3 as tl3
    assert len(mine) == len(ref) > 0
    assert _decisions(mine, tl3) == _decisions(ref, jl3)
    for a, b in zip(mine, ref):
        assert abs(a.aach_margin - b.aach_margin) <= 60 * llr_tol
        assert (a.tch_llrs is None) == (b.tch_llrs is None)
        if a.tch_llrs is not None:
            np.testing.assert_allclose(a.tch_llrs, b.tch_llrs, rtol=0,
                                       atol=llr_tol)


# --- RM(30,14) -------------------------------------------------------------

class TestRm3014:
    def test_tables_and_encode_equal(self):
        np.testing.assert_array_equal(trm.generator_matrix(),
                                      jrm.generator_matrix())
        np.testing.assert_array_equal(trm.codeword_table(),
                                      jrm.codeword_table())
        msgs = np.random.default_rng(1).integers(0, 2, (50, 14))
        np.testing.assert_array_equal(trm.encode(msgs), jrm.encode(msgs))

    def test_decode_soft_equals_the_reference(self):
        """Soft codewords under noise at several SNRs, batched as (5, 40,
        30): the same codewords, margins within 1e-5 x max|score|."""
        r = np.random.default_rng(2)
        msgs = r.integers(0, 2, (200, 14))
        signs = trm.encode(msgs).astype(np.float32) * 2 - 1
        noise = r.standard_normal(signs.shape).astype(np.float32)
        llrs = (signs + noise * np.repeat([0.3, 0.6, 0.9, 1.2], 50)[:, None]
                ).astype(np.float32).reshape(5, 40, 30)
        bits, margin = trm.decode_soft(torch.from_numpy(llrs))
        jbits, jmargin = jrm.decode_soft(jax.numpy.asarray(llrs))
        np.testing.assert_array_equal(bits.numpy(), np.asarray(jbits))
        assert bits.shape == (5, 40, 14) and margin.shape == (5, 40)
        scale = np.abs(llrs).sum(-1).max()
        assert np.abs(margin.numpy() - np.asarray(jmargin)).max() \
            <= MARGIN_TOL * scale
        assert (np.asarray(jbits).reshape(-1, 14)[:50] == msgs[:50]).all()

    def test_ties_and_hard_decisions(self):
        """Halfway between two codewords (a tie, margin 0) the lower
        message wins in both; decode_hard's distances are equal."""
        table = trm.codeword_table().astype(np.float32) * 2 - 1
        r = np.random.default_rng(3)
        pairs = np.sort(r.choice(1 << 14, (20, 2), replace=False), axis=1)
        x = (table[pairs[:, 0]] + table[pairs[:, 1]]) / 2
        bits, margin = trm.decode_soft(torch.from_numpy(x))
        jbits, jmargin = jrm.decode_soft(jax.numpy.asarray(x))
        np.testing.assert_array_equal(bits.numpy(), np.asarray(jbits))
        np.testing.assert_array_equal(margin.numpy(), np.asarray(jmargin))
        hard = r.integers(0, 2, (30, 30)).astype(np.uint8)
        for h in hard:
            a, b = trm.decode_hard(h), jrm.decode_hard(h)
            np.testing.assert_array_equal(a[0], b[0])
            assert a[1] == b[1]


# --- TCH coding ------------------------------------------------------------

@pytest.mark.parametrize("channel,depth", [
    ("TCH/7.2", 1), ("TCH/S", 1), ("TCH/4.8", 1), ("TCH/4.8", 4),
    ("TCH/4.8", 8), ("TCH/2.4", 4), ("TCH/2.4", 8)])
def test_tch_encode_decode_equal(channel, depth):
    """encode_tch bit for bit; decode_tch_soft on the encoded blocks with
    noise: the same bits (TCH/S: the same soft values, sign flips and a
    gather)."""
    k1 = tcc.TCH_GEOMETRY[channel][0]
    r = np.random.default_rng(depth * 7 + k1)
    blocks = r.integers(0, 2, (6, k1)).astype(np.uint8)
    ecc = 0x2ABCDE5
    t5 = tcc.encode_tch(blocks, channel, ecc30=ecc, depth=depth)
    np.testing.assert_array_equal(
        t5, jcc.encode_tch(blocks, channel, ecc30=ecc, depth=depth))
    llrs = (t5.astype(np.float32) * 2 - 1
            + 0.45 * r.standard_normal(t5.shape).astype(np.float32))
    got = tcc.decode_tch_soft(torch.from_numpy(llrs), channel, ecc30=ecc,
                              depth=depth).numpy()
    want = np.asarray(jcc.decode_tch_soft(jax.numpy.asarray(llrs), channel,
                                          ecc30=ecc, depth=depth))
    np.testing.assert_array_equal(got, want)
    if channel in ("TCH/4.8", "TCH/2.4"):
        assert (got == blocks).mean() > 0.99


def test_tch_s_mirror_equal():
    r = np.random.default_rng(4)
    for _ in range(3):
        f1, f2 = r.integers(0, 2, (2, 137)).astype(np.uint8)
        coded = tcc.tch_s_encode_block(f1, f2)
        np.testing.assert_array_equal(coded, jcc.tch_s_encode_block(f1, f2))
        soft = (coded.astype(np.float32) * 2 - 1
                + 0.5 * r.standard_normal(432).astype(np.float32))
        a, b = tcc.tch_s_decode_block(soft), jcc.tch_s_decode_block(soft)
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
        assert a[2] == b[2]


# --- spectrum --------------------------------------------------------------

def _cell_iq(offset_hz: float, slots: int = 8, seed: int = 0,
             snr_db=None):
    tx = tdl.DownlinkTransmitter(tdl.DownlinkConfig())
    iq = tx.modulate(tx.stream_bits(slots), snr_db=snr_db, seed=seed)
    t = np.arange(len(iq)) / 2.4e6
    return (iq * np.exp(2j * np.pi * offset_hz * t)).astype(np.complex64)


class TestSpectrum:
    def test_frames_and_detection_equal(self):
        x = _cell_iq(3000.0, snr_db=20)
        got = tsp.spectrum_frames_dbfs(torch.from_numpy(x), 2048,
                                       hop=1024).numpy()
        want = np.asarray(jsp.spectrum_frames_dbfs(jax.numpy.asarray(x),
                                                   2048, hop=1024))
        assert got.shape == want.shape and got.shape[0] > 10
        live = want > want.max() - 60.0
        assert np.abs(got - want)[live].max() <= DB_TOL
        assert np.abs(got - want).max() <= DB_TOL_ALL
        a = tsp.detect_signal(torch.from_numpy(got), 2.4e6)
        b = jsp.detect_signal(jax.numpy.asarray(got), 2.4e6)
        np.testing.assert_array_equal(a.signal_present.numpy(),
                                      np.asarray(b.signal_present))
        np.testing.assert_array_equal(a.afc_offset_hz.numpy(),
                                      np.asarray(b.afc_offset_hz))
        for fa, fb in zip(a[1:5], b[1:5]):
            np.testing.assert_allclose(fa.numpy(), np.asarray(fb),
                                       rtol=0, atol=DB_TOL)
        freqs = tsp.fft_freqs(2048, 2.4e6)
        np.testing.assert_array_equal(freqs, jsp.fft_freqs(2048, 2.4e6))
        avg = want.mean(0)
        assert tsp.parabolic_peak(avg, freqs, -2e4, 2e4) == \
            jsp.parabolic_peak(avg, freqs, -2e4, 2e4)
        assert tsp.spectrum_frames_dbfs(torch.zeros(100, dtype=torch.complex64)
                                        ).shape == (0, 2048)

    @pytest.mark.parametrize("offset", [1700.0, -6200.0])
    def test_offset_estimates_within_a_hertz(self, offset):
        """The single-cell centroid AFC and the grid-comb estimate on a
        cell `offset` Hz off: within 1 Hz of the reference's."""
        x = _cell_iq(offset, seed=3, snr_db=18)
        rx = tdl.DownlinkReceiver(device=CPU)
        mine = rx.estimate_offset(x)
        assert abs(mine - jdl.DownlinkReceiver.estimate_offset(x)) <= HZ_TOL
        assert abs(mine - offset) < 1500.0
        grid = tsp.estimate_grid_offset_hz(x, 2.4e6, device=CPU)
        assert abs(grid - jsp.estimate_grid_offset_hz(x, 2.4e6)) <= HZ_TOL


# --- the single-cell receiver ----------------------------------------------

def _tch_capture(channel, depth, slots, seed=1, snr_db=25.0, stch=None,
                 offset_hz=0.0):
    """The CLI simulation's shape: SCH/F MAC blocks on TN2, CMCE group
    call + SDS-TL text on TN4, TN3 traffic of `channel` at `depth`; the
    port's transmitter and the reference's give the same bits."""
    from tetraear_tpu.protocol import cmce as jcmce
    from tetraear_tpu.protocol import sds_tl as jsds
    from tetraear_tpu.protocol.mac import ChannelAllocation as JAlloc
    streams = []
    for dl, cmce, sds, alloc_cls in ((tdl, None, None, None),
                                     (jdl, jcmce, jsds, JAlloc)):
        if cmce is None:
            from tetraear_tpu_torch.protocol import cmce
            from tetraear_tpu_torch.protocol import sds_tl as sds
            from tetraear_tpu_torch.protocol.mac import (
                ChannelAllocation as alloc_cls)
        cell = dl.DownlinkConfig()
        tx = dl.DownlinkTransmitter(cell)
        payloads = {k: tsynth.make_mac_block_bits(f"MSG #{k}".encode(),
                                                  seed=k)
                    for k in range(slots) if k % 4 == 1}
        alloc = alloc_cls(allocation_type=1, timeslots=0b0010,
                          carrier_number=cell.main_carrier)
        slot = 3
        for pdu in [cmce.DSetup(call_identifier=41, call_priority=5,
                                transmission_grant=1,
                                calling_party=cmce.Address(1, 0x457)),
                    cmce.DSdsData(calling_party=cmce.Address(1, 0x457),
                                  short_data_type=3,
                                  data_bits=sds.build_text_transfer(
                                      "PARITY via SDS-TL")),
                    cmce.DRelease(call_identifier=41, disconnect_cause=2)]:
            if slot >= slots:
                break
            kw = ({"channel_allocation": alloc}
                  if isinstance(pdu, cmce.DSetup) else {})
            slot = tx.schedule_signalling(payloads, pdu, 0x2328, slot,
                                          slots, **kw)
        k1 = tcc.TCH_GEOMETRY[channel][0]
        voc = np.random.default_rng(seed).integers(
            0, 2, (max(1, slots // 4), k1)).astype(np.uint8)
        streams.append(tx.stream_bits(slots, payloads=payloads,
                                      tch_streams={3: (channel, voc, depth)},
                                      stch=stch))
    np.testing.assert_array_equal(streams[0], streams[1])
    iq = tdl.DownlinkTransmitter().modulate(streams[0], snr_db=snr_db,
                                            seed=seed)
    np.testing.assert_array_equal(
        iq, jdl.DownlinkTransmitter().modulate(streams[1], snr_db=snr_db,
                                               seed=seed))
    if offset_hz:
        t = np.arange(len(iq)) / 2.4e6
        iq = (iq * np.exp(2j * np.pi * offset_hz * t)).astype(np.complex64)
    return iq


@pytest.mark.parametrize("case", ["tchs_voice", "tch48_depth4_frame18",
                                  "stolen_stch", "auto_afc"])
def test_receiver_decisions_equal_the_reference(case):
    """DownlinkReceiver.receive on IQ captures: TCH/S voice slots (16
    slots), TCH/4.8 at depth 4 over a whole multiframe (72 slots, frame
    18 the control frame) with its per-TN de-interleave, a stolen
    half-slot carrying STCH, and a cell 900 Hz off with `auto` AFC."""
    stch_bits = tsynth.make_mac_block_bits(b"URGENT STCH", total_bits=124)
    kw = {"tchs_voice": ("TCH/S", 1, 16, {}),
          "tch48_depth4_frame18": ("TCH/4.8", 4, 72, {}),
          "stolen_stch": ("TCH/S", 1, 12, {"stch": {6: stch_bits}}),
          "auto_afc": ("TCH/S", 1, 16, {"offset_hz": 900.0})}[case]
    channel, depth, slots, extra = kw
    iq = _tch_capture(channel, depth, slots, **extra)
    off = "auto" if case == "auto_afc" else 0.0
    rx = tdl.DownlinkReceiver(traffic_channel=channel, traffic_depth=depth,
                              device=CPU)
    jrx = jdl.DownlinkReceiver(traffic_channel=channel, traffic_depth=depth)
    mine, ref = rx.receive(iq, freq_offset=off), jrx.receive(
        iq, freq_offset=off)
    _same_frames(mine, ref)
    assert rx.last_cell_ecc == jrx.last_cell_ecc
    assert _plain(rx.call_tracker.calls) == _plain(jrx.call_tracker.calls)
    assert any(f.layer3 for f in mine)
    if case == "tch48_depth4_frame18":
        assert {f.fn for f in mine} >= {17, 18, 1}
        got = rx.decode_traffic_stream(mine, tn=3)
        want = jrx.decode_traffic_stream(ref, tn=3)
        np.testing.assert_array_equal(got, want)
        assert got.shape[0] >= 10
    if case == "stolen_stch":
        stolen = [f for f in mine if f.stolen]
        assert len(stolen) == 1 and stolen[0].crc_ok
        assert bytes(stolen[0].mac_pdu.data) == b"URGENT STCH"
    if case in ("tchs_voice", "auto_afc"):
        assert sum(f.voice_block is not None for f in mine) >= 3


def test_common_key_bruteforce_equal():
    """An SCH/F payload encrypted under a built-in TEA1 key, received
    with auto_decrypt: the same decrypted bytes, key label and score."""
    from tetraear_tpu_torch.crypto.keys import COMMON_KEYS
    from tetraear_tpu_torch.crypto.tea import TEAEncryptor
    key = COMMON_KEYS["TEA1"][0]
    pt = b"SECRET MESSAGE 123"
    pt += b"\x00" * (-len(pt) % 8)
    ct = TEAEncryptor(key, "TEA1").encrypt(pt)
    pay = {1: tsynth.make_mac_block_bits(ct, encryption_mode=1, seed=1)}
    bits = tdl.DownlinkTransmitter().stream_bits(4, pay)
    mine = tdl.DownlinkReceiver(auto_decrypt=True, device=CPU
                                ).receive_bits(bits)
    ref = jdl.DownlinkReceiver(auto_decrypt=True).receive_bits(bits)
    _same_frames(mine, ref)
    enc = [f for f in mine if f.encrypted]
    assert len(enc) == 1 and enc[0].decrypted
    assert b"SECRET MESSAGE 123" in enc[0].decrypted_data


# --- multicarrier front and survey -----------------------------------------

def test_ddc_kernel_conv_equals_channelize():
    """The reference's dense-conv DDC front (ops/fused.ddc_kernel, its
    TPU path) and `channelize` (K5's function, the port's path on every
    device) compute the same carriers: the kernel array_equal to the
    reference's, the conv within the rounding of the f32 mixer phase that
    channelize computes (2^-23 x max|phase| x max|y|, phase = 2 pi f_c
    t; the dense kernel's phases are exact float64) plus the sums'
    1e-5 x max|y|, on the CPU."""
    offs = tch.carrier_grid(4)
    kernel, gc, rot = tfused.ddc_kernel(offs, 2.4e6, 10, 12)
    jk, jgc, jrot = jfused.ddc_kernel(np.asarray(offs, np.float64), 2.4e6,
                                      10, 12)
    np.testing.assert_array_equal(kernel, np.asarray(jk))
    assert gc == jgc == 60
    np.testing.assert_array_equal(rot, np.asarray(jrot))
    x = _cell_iq(12_500.0, slots=8, seed=5)[:200_003]
    xt = torch.from_numpy(x)
    taps = tfir.design_decimation_fir(10, 12)
    assert len(taps) == 121
    want = tch.channelize(xt, offs, 2.4e6, 10, taps).numpy()
    got = tfused.fused_channelize(xt, kernel, gc, rot, 10).numpy()
    assert got.shape == want.shape == (4, 20_001)
    max_phase = 2 * np.pi * np.abs(offs).max() * len(x) / 2.4e6
    bound = (2.0 ** -23 * max_phase + 1e-5) * np.abs(want).max()
    assert np.abs(got - want).max() <= bound


def test_multicarrier_and_survey_equal_the_reference():
    """Three cells on carriers 0, 1 and 3 of carrier_grid(4), 12 slots
    each: every carrier's frames equal the reference's, each cell's
    identity and text is decoded, and survey_cells reports what the
    reference's does."""
    x, want = tsynth.planted_cells((0, 1, 3), num_carriers=4, slots=12)
    rx = tdl.MulticarrierDownlinkReceiver(4, device=CPU)
    mine = rx.receive(x)
    ref = jdl.MulticarrierDownlinkReceiver(4).receive(x)
    assert len(mine) == len(ref) == 4 and mine[2] == [] == ref[2]
    for c, (mcc, mnc, cc_, text) in want.items():
        _same_frames(mine[c], ref[c], LLR_TOL_MC)
        sb = [f for f in mine[c] if f.sync_pdu is not None][0]
        assert (sb.sync_pdu.mcc, sb.sync_pdu.mnc,
                sb.sync_pdu.colour_code) == (mcc, mnc, cc_)
        assert text in {f.sds_message for f in mine[c]}
    reports = tdl.survey_cells(x, num_carriers=4, device=CPU)
    assert _plain(reports) == _plain(jdl.survey_cells(x, num_carriers=4))
    assert [r.carrier_index for r in reports] == [0, 1, 3]


# --- the CLI ---------------------------------------------------------------

@pytest.mark.parametrize("argv", [
    ["--simulate"],
    ["--simulate", "--slots", "40", "--traffic-channel", "TCH/4.8",
     "--traffic-depth", "4", "--freq-offset", "auto"]],
    ids=["tchs", "tch48_depth4_auto"])
def test_downlink_cli_equals_jax_cli(tmp_path, capsys, argv):
    """`downlink --simulate` (TCH/S with coded speech where the codec
    builds) and TCH/4.8 at depth 4 with `auto` AFC: the same IQ file,
    the same JSONL byte for byte and the same per-slot, [TCH] and
    [VOICE] lines as the JAX package's CLI."""
    iq, out, ref = (tmp_path / "sim.cf32", tmp_path / "port.jsonl",
                    tmp_path / "jax.jsonl")
    assert cli.main(["downlink", str(iq), *argv, "--device", "cpu", "-o",
                     str(out)]) == 0
    mine = capsys.readouterr().out.splitlines()
    sim = iq.read_bytes()
    assert jax_cli.main(["downlink", str(iq), *argv, "-o", str(ref)]) == 0
    theirs = capsys.readouterr().out.splitlines()
    assert iq.read_bytes() == sim
    assert out.read_text() == ref.read_text()
    keep = ("TN", "[TCH]", "[VOICE]", "[SIM] TCH")
    assert ([line for line in mine if line.startswith(keep)]
            == [line for line in theirs if line.startswith(keep)])
    rows = [json.loads(line) for line in out.read_text().splitlines()]
    assert any(r["sds"] and "via SDS-TL" in r["sds"] for r in rows) or \
        any(r["layer3"] for r in rows)


def test_downlink_survey_cli_equals_jax_cli(tmp_path, capsys):
    """`downlink FILE --survey 4` on three planted cells: the same cell
    lines as the JAX package's CLI."""
    x, want = tsynth.planted_cells((0, 2, 3), num_carriers=4, slots=8)
    iq = tmp_path / "cells.cf32"
    x.tofile(iq)
    assert cli.main(["downlink", str(iq), "--survey", "4", "--device",
                     "cpu"]) == 0
    mine = capsys.readouterr().out.splitlines()
    assert jax_cli.main(["downlink", str(iq), "--survey", "4"]) == 0
    theirs = capsys.readouterr().out.splitlines()
    cells = [line for line in mine if line.startswith("carrier")]
    assert cells == [line for line in theirs if line.startswith("carrier")]
    assert len(cells) == 3
    for c, (mcc, mnc, cc_, _) in want.items():
        assert any(f"carrier {c:3d}" in line and f"MNC={mnc} CC={cc_}"
                   in line for line in cells)
