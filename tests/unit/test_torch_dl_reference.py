"""The port's ETSI downlink against the benchmark's plain reference
(benchmark/reference_dl.py, float64 PyTorch written from EN 300 392-2),
on the CPU at a small size: the channel decodes, RM(30,14) and the
scrambler exact; the etsi demod's hard bits equal to the reference's on
a clean multiframe; `demodulate` + `decode` equal to `receive`; the cell
`dl.multiframe` through `harness.run` correct, and its controls and
planted faults not correct."""

import dataclasses
import json
import zlib
from unittest import mock

import numpy as np
import pytest
import torch

from benchmark import compare, faults_dl, harness
from benchmark.drivers import downlink as D
from benchmark import reference_dl as R
from tetraear_tpu_torch.models import downlink as dl
from tetraear_tpu_torch.models.receiver_etsi import EtsiReceiver
from tetraear_tpu_torch.ops import channel_coding as cc
from tetraear_tpu_torch.ops import rm3014, scramble
from tetraear_tpu_torch.protocol.layer3 import describe_pdu
from tetraear_tpu_torch.ui import cli

CPU = torch.device("cpu")
GROUPS = [("BSCH", 0), ("SCH/HD", 0x1234567), ("SCH/F", 0x1234567),
          ("STCH", 0x2BCDEF1)]


def _dl_cell(slots=24, chunks=2, snr=(-5.0, -13.0)):
    """The cell at the CPU's size: `chunks` multiframes of `slots` slots;
    every width, rate and code of the configuration kept."""
    cell = harness.Cell("dl.multiframe")
    cell.params.update(slots=slots, ring_chunks=chunks, snr_db=list(snr))
    return cell


@pytest.mark.parametrize("ecc", [0, 1, 0x2ABCDEF, 0x3FFFFFFF,
                                 R.extended_colour_code(262, 1001, 17)])
def test_scrambling_sequence_equal(ecc):
    assert np.array_equal(scramble.scrambling_sequence(ecc, 432),
                          R.scrambling_bits(ecc, 432))


def test_rm3014_codewords_and_decode_equal():
    assert np.array_equal(rm3014.codeword_table(), R.rm_codewords())
    rng = np.random.default_rng(5)
    soft = torch.from_numpy(rng.standard_normal((512, 30)).astype(np.float32))
    bits, _ = rm3014.decode_soft(soft)
    assert np.array_equal(bits.numpy(), R.rm_decode(soft).numpy())
    msgs = rng.integers(0, 2, (64, 14)).astype(np.uint8)
    coded = rm3014.encode(msgs).astype(np.float32) * 2 - 1
    noisy = coded + 0.8 * rng.standard_normal(coded.shape).astype(np.float32)
    bits, _ = rm3014.decode_soft(torch.from_numpy(noisy))
    assert np.array_equal(bits.numpy(), R.rm_decode(torch.from_numpy(noisy)))


@pytest.mark.parametrize("sigma", [None, 0.5, 0.8, 1.1])
@pytest.mark.parametrize("channel,ecc", GROUPS)
def test_channel_decode_equal(channel, ecc, sigma):
    """The port's channel decode and the reference's: the same type-1 bits
    and CRC verdicts, on noisy encodes of random blocks (sigma, soft
    values +-1) and on random soft values (sigma None)."""
    rng = np.random.default_rng(zlib.crc32(f"{channel} {sigma}".encode()))
    k1, air = cc.CHANNEL_GEOMETRY[channel]
    if sigma is None:
        soft = rng.standard_normal((96, air))
    else:
        msgs = rng.integers(0, 2, (96, k1)).astype(np.uint8)
        coded = np.stack([cc.encode_channel(m, channel, ecc30=ecc)
                          for m in msgs])
        soft = coded * 2.0 - 1.0 + sigma * rng.standard_normal(coded.shape)
    soft = torch.from_numpy(soft.astype(np.float32))
    mine = cc.decode_channel_soft(soft, channel, ecc30=ecc)
    bits, ok = R.decode_channel(soft, channel, ecc)
    assert np.array_equal(mine.bits.numpy(), bits.numpy())
    assert np.array_equal(mine.crc_ok.numpy(), ok.numpy())
    if sigma == 0.5:
        assert ok.all()
    if sigma is None:
        assert not ok.any()


def test_path_gap_is_zero_on_the_best_path_and_not_elsewhere():
    rng = np.random.default_rng(3)
    soft = torch.from_numpy(rng.standard_normal((8, 432)).astype(np.float32))
    bits, ok = R.decode_channel(soft, "SCH/F", 77)
    gap, held_ok, tol = R.path_gap(soft, "SCH/F", 77, bits)
    assert torch.all(gap == 0) and torch.equal(held_ok, ok)
    other = bits.clone()
    other[:, 5] ^= 1
    gap, _, tol = R.path_gap(soft, "SCH/F", 77, other)
    assert torch.all(gap > tol)


def test_etsi_demod_hard_bits_equal_the_reference():
    """On a clean 24-slot multiframe the etsi chain's hard decisions are
    the reference's, symbol for symbol."""
    x = dl.simulate_multiframe(24, snr_db=None, seed=4).iq
    res = EtsiReceiver(device=CPU)(x)
    n = int(res.count) - 1
    mine = (res.soft_bits[:n].numpy() > 0)
    ref = (R.demod(torch.from_numpy(x)).numpy() > 0)
    assert abs(len(ref) - n) <= 1
    m = min(n, len(ref))
    assert np.array_equal(mine[8:m - 8], ref[8:m - 8])


def _record(f) -> str:
    return json.dumps([cli._downlink_record(f, describe_pdu),
                       f.to_frame_dict(), f.slot_index,
                       None if f.mac_bits is None else f.mac_bits.tolist()],
                      default=str)


@pytest.mark.parametrize("snr", [-5.0, -13.0])
def test_demodulate_and_decode_equal_receive(snr):
    x = dl.simulate_multiframe(24, "UNIT 001", snr, seed=9, start_mn=33).iq
    a = dl.DownlinkReceiver(device=CPU)
    b = dl.DownlinkReceiver(device=CPU)
    whole = a.receive(x)
    halves = b.decode(b.demodulate(x))
    assert len(whole) == len(halves) > 20
    assert [_record(f) for f in whole] == [_record(f) for f in halves]
    assert a.call_tracker.__dict__.keys() == b.call_tracker.__dict__.keys()
    assert a.last_cell_ecc == b.last_cell_ecc


def test_demodulate_takes_the_auto_offset():
    x = dl.simulate_multiframe(16, snr_db=20.0, seed=2).iq
    rx = dl.DownlinkReceiver(device=CPU)
    frames = rx.decode(rx.demodulate(x, "auto"))
    assert [_record(f) for f in frames] == [
        _record(f) for f in dl.DownlinkReceiver(device=CPU).receive(
            x, freq_offset="auto")]


def test_generator_plan_matches_its_capture():
    sim = dl.simulate_multiframe(72, "CREW 314", -5.0, seed=12345,
                                 start_mn=59)
    assert len(sim.iq) == 2_449_733
    assert sim.cell.start_mn == 59 and not sim.voiced
    frames = dl.DownlinkReceiver(device=CPU).receive(sim.iq)
    assert {f.mn for f in frames} == {59}
    for f in frames:
        k = (f.fn - 1) * 4 + f.tn - 1
        if f.channel == "SCH/F" and f.crc_ok:
            want = sim.payloads.get(k, np.zeros(268, np.uint8))
            assert np.array_equal(f.mac_bits, want)
    texts = [f.sds_message for f in frames if f.sds_message]
    assert "[TXT] CREW 314 #1" in texts and "CREW 314 via SDS-TL" in texts


# --- the cell through the harness ------------------------------------------

def _run(cell, seed, factory=None, ring=None, seconds=0.5):
    result, _ = harness.run(cell, seed, seconds, False, "cpu", 0.0,
                            system_factory=factory, ring=ring)
    return result


def test_cell_on_the_cpu_is_correct():
    result = _run(_dl_cell(slots=72), 2**31 + 3)
    check = result["check"]
    assert result["correct"], check
    assert check["slot_diff"] == {"value": 0, "limit": 0}
    assert check["frames_diff"] == {"value": 0, "limit": 0}
    assert check["crc_loss"]["value"] < check["crc_loss"]["limit"]
    assert 0 < check["soft_gap"]["value"] < check["soft_gap"]["limit"]
    assert result["info"]["slots_checked"] > 50
    assert result["info"]["ties"] >= 0
    assert set(result["metrics"]) == {"iq_rate", "chunk_p95", "setup_s"}


@pytest.mark.parametrize("system", ["control", "bf16"])
def test_controls_on_the_cpu(system):
    """Neither control is correct: the one whose demod rounds its filtered
    signal to float8 by soft_gap alone (its own soft bits decode as the
    reference decodes them), the one with bfloat16 path metrics by
    slot_diff."""
    cell = _dl_cell(slots=72, chunks=2, snr=(-13.0,))
    seed = 2**31 + 11
    ring = cell.driver.make_ring(cell.config, cell.params, seed, "cpu")
    result = _run(cell, seed, faults_dl.factory(cell, system, ring), ring,
                  seconds=2.0)
    check = result["check"]
    assert check["frames_diff"]["value"] == 0
    assert not result["correct"]
    if system == "bf16":
        assert check["slot_diff"]["value"] > 0
    else:
        assert check["slot_diff"]["value"] == 0
        assert check["soft_gap"]["value"] > check["soft_gap"]["limit"]


@pytest.mark.parametrize("fault", D.FAULTS)
def test_fault_is_not_correct(fault):
    """Each planted fault, run over every chunk of the ring and checked as
    the harness checks its sample, comes out not correct.  A soft bit
    flipped in a slot changes the decode only of a block near the
    decoding threshold (the codes correct it elsewhere), so the ring is
    four multiframes at the cell's edge SNR, where about one in two
    shows it."""
    cell = _dl_cell(slots=72, chunks=4, snr=(-13.0,))
    ring = cell.driver.make_ring(cell.config, cell.params, 2**31 + 5, CPU)
    system = faults_dl.factory(cell, fault, ring)(cell.config, CPU)
    samples = []
    for idx, x in enumerate(ring.chunks):
        res = system.submit(x, 0)
        samples.append((idx, cell.driver.to_host(res), system.complete(res)))
    numbers, _ = cell.driver.check(cell.config, ring, samples, CPU)
    correct, _ = compare.judge(numbers, cell.limits)
    assert not correct, numbers
    assert numbers["slot_diff"] > 0


def test_same_seed_same_ring():
    cell = _dl_cell()
    a = cell.driver.make_ring(cell.config, cell.params, 3 * 2**40 + 1, CPU)
    b = cell.driver.make_ring(cell.config, cell.params, 3 * 2**40 + 1, CPU)
    c = cell.driver.make_ring(cell.config, cell.params, 3 * 2**40 + 2, CPU)
    assert all(np.array_equal(x, y) for x, y in zip(a.chunks, b.chunks))
    assert [p["texts"] for p in a.plans] == [p["texts"] for p in b.plans]
    assert not np.array_equal(a.chunks[0], c.chunks[0])


def test_system_refuses_a_receiver_without_halves(monkeypatch):
    """A program without `demodulate` fails at once, as the parent does."""
    cell = _dl_cell()
    monkeypatch.delattr(dl.DownlinkReceiver, "demodulate")
    with pytest.raises(SystemExit):
        cell.driver.System(cell.config, CPU)


def test_reference_imports_nothing_of_the_program():
    import ast
    from pathlib import Path
    src = Path(R.__file__).read_text()
    names = set()
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add((node.module or "").split(".")[0])
    assert names <= {"__future__", "functools", "math", "numpy", "torch"}


def test_frames_diff_reads_the_plan():
    """A frame whose CRC passed with bits other than the planted ones, and
    a planted text gone, each count once."""
    cell = _dl_cell(slots=24, chunks=1, snr=(-5.0,))
    ring = cell.driver.make_ring(cell.config, cell.params, 7, CPU)
    frames = dl.DownlinkReceiver(device=CPU).receive(ring.chunks[0])
    plan = ring.plans[0]
    assert cell.driver.frames_diff(frames, plan) == 0
    bad = [dataclasses.replace(f) for f in frames]
    schf = [i for i, f in enumerate(bad) if f.channel == "SCH/F"
            and f.crc_ok and (f.fn - 1) * 4 + f.tn - 1 in plan["texts"]]
    bad[schf[0]].sds_message = "[TXT] SOMETHING ELSE"
    assert cell.driver.frames_diff(bad, plan) == 1
    bits = bad[schf[1]].mac_bits.copy()
    bits[-1] ^= 1
    bad[schf[1]].mac_bits = bits
    assert cell.driver.frames_diff(bad, plan) == 2


def test_slot_diff_counts_ties_apart():
    """A block whose bits differ from the reference's counts as a tie, not
    a wrong slot, where path_gap puts it within the float32 rounding, and
    as wrong where it does not."""
    cell = _dl_cell(slots=24, chunks=1, snr=(-5.0,))
    ring = cell.driver.make_ring(cell.config, cell.params, 11, CPU)
    rx = dl.DownlinkReceiver(device=CPU)
    res = rx.demodulate(ring.chunks[0], 0.0)
    frames = rx.decode(res)
    ref = R.decode(torch.as_tensor(D.to_host(res)["soft"]))
    assert D.slot_diff(frames, ref) == (0, 0)
    i = next(i for i, f in enumerate(frames) if f.channel == "SCH/F")
    bits = frames[i].mac_bits.copy()
    bits[0] ^= 1
    other = [dataclasses.replace(f) for f in frames]
    other[i].mac_bits = bits
    assert D.slot_diff(other, ref) == (1, 0)
    tied = lambda *a: (torch.zeros(1), torch.tensor([frames[i].crc_ok]),
                       torch.ones(1))
    with mock.patch.object(R, "path_gap", tied):
        assert D.slot_diff(other, ref) == (0, 1)


def test_soft_gap_is_the_median_inside_the_edges():
    a = torch.zeros(2 * 100, dtype=torch.float64)
    b = a.clone()
    b[:16] = 5.0                          # the first 8 symbols: not read
    assert D._soft_gap(a, b) == 0.0
    b[16:] = 0.3                          # each pair 0.3 * sqrt(2) away
    b[40:60] = 2.0                        # ten symbols far off: not the median
    assert D._soft_gap(a, b[:-2]) == pytest.approx(0.3 * 2 ** 0.5)


def test_faults_runner_is_control_py_s(monkeypatch):
    """faults_dl.py runs control.py's runner with the downlink's systems,
    and like it refuses without a CUDA card."""
    from benchmark import control
    monkeypatch.setattr(control, "factory", control.factory)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert faults_dl.main(["--workload", "dl.multiframe", "--seeds", "1"]) == 2
    assert control.factory is faults_dl.factory
