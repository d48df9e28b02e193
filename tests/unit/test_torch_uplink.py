"""The port's uplink monitors (models/uplink.py) against the JAX
package, on the CPU: the transmitters' bits and IQ equal, and the
isolated-burst `UplinkMonitor` and the slot-synchronous
`UplinkSlotMonitor` make the same decisions (burst positions, kinds,
channels, CRC verdicts, MAC bits, SDS texts, layer-3 descriptions,
TN/FN/MN, timing offsets, voice blocks) on bit streams and over the air;
the `uplink` CLI writes the JAX CLI's JSONL.  Traffic soft values go
through the etsi demodulator, whose f32 rounding differs between the
packages: the voice blocks they quantize are compared exactly, as the
decisions they are."""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from tetraear_tpu.models import uplink as jul
from tetraear_tpu.ops import channel_coding as jcc
from tetraear_tpu.protocol import cmce as jcmce
from tetraear_tpu.protocol import layer3 as jl3
from tetraear_tpu.protocol import sds_tl as jsds
from tetraear_tpu.ui import cli as jax_cli

from tetraear_tpu_torch.models import uplink as tul
from tetraear_tpu_torch.models.downlink import advance_tdma
from tetraear_tpu_torch.ops import channel_coding as tcc
from tetraear_tpu_torch.protocol import cmce as tcmce
from tetraear_tpu_torch.protocol import layer3 as tl3
from tetraear_tpu_torch.protocol import sds_tl as tsds
from tetraear_tpu_torch.ui import cli
from tetraear_tpu_torch.utils.synth import make_mac_block_bits

CPU = torch.device("cpu")
ECC = (262 << 20) | (1001 << 6) | 17


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


def _view(frames, layer3) -> list:
    """Every decision of each uplink frame, as plain values."""
    out = []
    for f in frames:
        out.append({
            "kind": f.kind, "start": f.start_bit, "channel": f.channel,
            "crc_ok": f.crc_ok,
            "mac_bits": None if f.mac_bits is None else f.mac_bits.tolist(),
            "mac_data": (None if f.mac_pdu is None
                         else bytes(f.mac_pdu.data).hex()),
            "sds": f.sds_message,
            "layer3": [layer3.describe_pdu(r) for r in f.layer3 or []],
            "tdma": (f.tn, f.fn, f.mn, f.slot_index, f.timing_offset),
            "voice": None if f.voice_block is None else f.voice_block.hex(),
            "tch_bits": None if f.tch_bits is None else f.tch_bits.tolist()})
    return out


def _bursts(mods, cmce, sds, ecc):
    """The CLI simulation's four bursts from one package's transmitter."""
    tx = mods.UplinkTransmitter(ecc)
    return tx, [
        tx.nub_bits(make_mac_block_bits(b"LEGACY UPLINK SDS", seed=1)),
        tx.access_cb(cmce.USdsData(called_party=cmce.Address(0, 0x2A),
                                   short_data_type=0, user_data=0xBEEF),
                     ssi=0xABCD),
        tx.signalling_nub(cmce.USetup(basic_service_info=0, call_priority=5,
                                      called_party=cmce.Address(1, 0x2328)),
                          ssi=0x777),
        tx.signalling_nub(cmce.USdsData(
            called_party=cmce.Address(1, 0x2328), short_data_type=3,
            data_bits=sds.build_text_transfer("uplink report 7")),
            ssi=0x777),
        tx.signalling_nub(cmce.UStatus(called_party=cmce.Address(1, 9000),
                                       precoded_status=3), ssi=0x101)]


def _same_bursts():
    (ttx, tb), (jtx, jb) = (_bursts(tul, tcmce, tsds, ECC),
                            _bursts(jul, jcmce, jsds, ECC))
    assert len(tb) == len(jb)
    for a, b in zip(tb, jb):
        np.testing.assert_array_equal(a, b)
    return ttx, jtx, tb


@pytest.mark.parametrize("snr_db", [None, 14.0])
def test_isolated_monitor_equals_the_reference(snr_db):
    """The four CLI bursts and a U-STATUS as isolated transmissions:
    bit streams (receive_bits) and IQ (receive) at clean and 14 dB."""
    ttx, jtx, bursts = _same_bursts()
    iq = ttx.transmit(bursts, snr_db=snr_db, seed=2)
    np.testing.assert_array_equal(iq, jtx.transmit(bursts, snr_db=snr_db,
                                                   seed=2))
    mon, jmon = tul.UplinkMonitor(ECC, device=CPU), jul.UplinkMonitor(ECC)
    mine, ref = mon.receive(iq), jmon.receive(iq)
    assert _view(mine, tl3) == _view(ref, jl3)
    assert len(mine) >= (5 if snr_db is None else 3)
    stream = np.concatenate([np.zeros(50, np.uint8)]
                            + [np.concatenate([b, np.ones(37, np.uint8)])
                               for b in bursts])
    assert _view(mon.receive_bits(stream), tl3) == _view(
        jmon.receive_bits(stream), jl3)
    assert tul.UplinkMonitor(ECC + 1, device=CPU).receive_bits(stream) == \
        [] == jul.UplinkMonitor(ECC + 1).receive_bits(stream)


def test_slot_monitor_equals_the_reference():
    """The slot-synchronous monitor on the grid: signalling NUBs, a CB
    in the second half of a slot, TCH/S traffic on TN3 and a 2-bit clock
    slip mid-stream, from anchor (2, 7, 30); then over the air."""
    ttx, jtx, bursts = _same_bursts()
    r = np.random.default_rng(4)
    voc = r.integers(0, 2, (2, 432)).astype(np.uint8)
    t5 = tcc.encode_tch(voc, "TCH/S", ecc30=ECC)
    np.testing.assert_array_equal(t5, jcc.encode_tch(voc, "TCH/S",
                                                     ecc30=ECC))
    # anchor (2, 7, 30): slot k is TN (k + 1) % 4 + 1 -> TN3 = slots 1, 5, 9
    slot_map = {0: bursts[0], 2: bursts[2], 3: bursts[3],
                5: ttx.traffic_nub(t5[0]), 6: bursts[4],
                9: ttx.traffic_nub(t5[1]), 10: bursts[1]}
    bits = ttx.slot_stream_bits(slot_map, 13, lead_bits=137, seed=5)
    np.testing.assert_array_equal(
        bits, jtx.slot_stream_bits(slot_map, 13, lead_bits=137, seed=5))
    cut = 137 + 7 * 510
    slipped = np.concatenate([bits[:cut], np.array([1, 0], np.uint8),
                              bits[cut:]])
    kw = dict(anchor=(2, 7, 30), traffic_tns={3: "TCH/S"})
    mon = tul.UplinkSlotMonitor(ECC, device=CPU, **kw)
    jmon = jul.UplinkSlotMonitor(ECC, **kw)
    for stream in (bits, slipped):
        mine = mon.receive_bits(stream)
        assert _view(mine, tl3) == _view(jmon.receive_bits(stream), jl3)
        assert mon.grid_phase == jmon.grid_phase
        assert {f.slot_index for f in mine} >= {0, 2, 3, 5, 6, 9}
        for f in mine:
            assert (f.tn, f.fn, f.mn) == advance_tdma(2, 7, 30,
                                                      f.slot_index)
    assert sum(f.voice_block is not None for f in mine) == 2
    assert any(f.timing_offset == 2 for f in mine)
    iq = ttx.transmit_slots(slot_map, 13, lead_bits=120, snr_db=20.0,
                            seed=2)
    mine = mon.receive(iq)
    assert _view(mine, tl3) == _view(jmon.receive(iq), jl3)
    assert len(mine) >= 6
    assert tul.advance_tdma_coords((2, 7, 30), 75) == \
        jul.advance_tdma_coords((2, 7, 30), 75)


def test_frames_are_plain_dataclasses_like_the_reference():
    a = [f.name for f in dataclasses.fields(tul.UplinkFrame)]
    assert a == [f.name for f in dataclasses.fields(jul.UplinkFrame)]


@pytest.mark.parametrize("argv", [
    [], ["--continuous"], ["--continuous", "--anchor", "3:17:60",
                           "--snr-db", "16"]],
    ids=["isolated", "continuous", "continuous_anchor"])
def test_uplink_cli_equals_jax_cli(tmp_path, capsys, argv):
    """`uplink --simulate` (isolated bursts, the slot-synchronous monitor
    with coded speech on TN3 where the codec builds, and another anchor
    at 16 dB): the same IQ file, the same JSONL byte for byte and the
    same burst lines as the JAX package's CLI."""
    iq, out, ref = (tmp_path / "ul.cf32", tmp_path / "port.jsonl",
                    tmp_path / "jax.jsonl")
    assert cli.main(["uplink", str(iq), "--simulate", *argv, "--device",
                     "cpu", "-o", str(out)]) == 0
    mine = capsys.readouterr().out.splitlines()
    sim = iq.read_bytes()
    assert jax_cli.main(["uplink", str(iq), "--simulate", *argv, "-o",
                         str(ref)]) == 0
    theirs = capsys.readouterr().out.splitlines()
    assert iq.read_bytes() == sim
    assert out.read_text() == ref.read_text()
    keep = ("bit", "[VOICE]", "[SIM] TN3")
    assert ([line for line in mine if line.startswith(keep)]
            == [line for line in theirs if line.startswith(keep)])
    rows = [json.loads(line) for line in out.read_text().splitlines()]
    assert len(rows) >= 4
    assert any("uplink report 7" in " ".join(r["layer3"] or [])
               for r in rows)
