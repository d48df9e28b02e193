"""The spans and counters of the port's ETSI downlink
(`DownlinkReceiver.demodulate` / `decode`, `ops/viterbi.viterbi_decode`;
`tetraear_tpu_torch.utils.metrics`), on the CPU: recorded exactly while a
torch.profiler session runs, changing no frame; the inner spans lie under
`tetra.downlink` and the counters count what was done; the benchmark's
eight downlink readers find them in a traced window of the cell
`dl.multiframe`, and nothing in an empty record."""

import contextlib
import json

import pytest
import torch

from benchmark import harness
from tetraear_tpu_torch.models import downlink as dl
from tetraear_tpu_torch.ops import viterbi
from tetraear_tpu_torch.protocol.layer3 import describe_pdu
from tetraear_tpu_torch.ui import cli
from tetraear_tpu_torch.utils import metrics

CPU = torch.device("cpu")
INNER = ("dl.acquire", "dl.aach", "dl.channel", "dl.assemble", "viterbi")
COUNTERS = ("viterbi.steps", "viterbi.blocks", "viterbi.kernel", "dl.slots",
            "dl.crc_checked", "dl.crc_passed")
READERS = ("dl.decode.ms", "dl.demod.ms", "dl.acquire.ms", "dl.channel.ms",
           "dl.assemble.ms", "dl.viterbi.ms", "dl.crc_yield",
           "dl.viterbi_kernel_share")


@pytest.fixture(scope="module")
def captures():
    """Two 24-slot captures, a near cell and one at the edge of reach."""
    return [dl.simulate_multiframe(24, "GATE 017", snr, seed=s,
                                   start_mn=5).iq
            for s, snr in ((3, -5.0), (4, -13.0))]


def _profile():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


def _loop(captures):
    """The benchmark's pipelining over the captures on one receiver."""
    rx = dl.DownlinkReceiver(device=CPU)
    out, pending = [], None
    for x in captures:
        res = rx.demodulate(x)
        if pending is not None:
            out.append(rx.decode(pending))
        pending = res
    out.append(rx.decode(pending))
    return out


def _lines(chunks) -> list:
    return [json.dumps([cli._downlink_record(f, describe_pdu),
                        f.to_frame_dict(), f.crc_ok], default=str)
            for frames in chunks for f in frames]


def _count_viterbi(monkeypatch) -> dict:
    n = {"calls": 0, "steps": 0, "blocks": 0}
    real = viterbi.viterbi_decode

    def counted(llrs, num_input_bits, terminated=True):
        n["calls"] += 1
        n["steps"] += num_input_bits
        n["blocks"] += llrs.reshape(-1, 4 * num_input_bits).shape[0]
        return real(llrs, num_input_bits, terminated)
    monkeypatch.setattr(viterbi, "viterbi_decode", counted)
    return n


@pytest.fixture(scope="module")
def traced(captures):
    """An untraced run, then the same captures under a CPU profiler
    session: (untraced frames, traced frames, snapshot, profiler event
    names, Viterbi calls counted)."""
    plain = _loop(captures)
    with pytest.MonkeyPatch.context() as mp:
        n = _count_viterbi(mp)
        with _profile() as prof:
            out = _loop(captures)
    names = [e.name for e in prof.events()]
    return plain, out, metrics.snapshot(), names, n


def test_off_records_nothing_and_changes_nothing(captures, monkeypatch):
    """With no profiler the record stays empty, and the frames equal a run
    with the recorder's code path taken out."""
    metrics.RECORDER._reset()
    plain = _loop(captures)
    snap = metrics.snapshot()
    assert (snap["chunks"], snap["spans"], snap["counters"],
            snap["records"]) == ({}, {}, {}, [])
    monkeypatch.setattr(dl, "span", lambda name: contextlib.nullcontext())
    monkeypatch.setattr(dl, "tracing", lambda: False)
    monkeypatch.setattr(viterbi, "tracing", lambda: False)
    assert _lines(plain) == _lines(_loop(captures))


def test_traced_frames_are_identical(traced):
    plain, out, *_ = traced
    assert _lines(plain) == _lines(out) and len(_lines(out)) > 40


def test_inner_spans_lie_under_the_decode(traced):
    """Each chunk is one `tetra.downlink.demod` and one `tetra.downlink`
    span, both roots; every inner span is summed under the latter, none
    stands apart, and each runs once a chunk but the Viterbi."""
    _, out, snap, _, n = traced
    assert snap["chunks"] == {"tetra.downlink.demod": 2, "tetra.downlink": 2}
    assert all(r["parent"] is None for r in snap["records"])
    decodes = [r for r in snap["records"] if r["name"] == "tetra.downlink"]
    for r in decodes:
        assert set(r["inner"]) == set(INNER)
        for name in INNER[:-1]:
            assert r["inner"][name][1] == 1
        inner_ns = sum(r["inner"][k][0] for k in INNER[:-1])
        assert inner_ns <= r["end_ns"] - r["start_ns"]
    for r in snap["records"]:
        if r["name"] == "tetra.downlink.demod":
            assert r["inner"] == {}
    assert snap["spans"]["viterbi"]["count"] == n["calls"]


def test_counters_count_what_was_done(traced):
    """viterbi.steps is the sum of the calls' trellis lengths and
    viterbi.blocks of their blocks, viterbi.kernel the blocks the CUDA
    kernel decoded (none on the CPU); dl.slots the frames (one a slot on
    the grid), dl.crc_checked the frames whose crc_ok is not None and
    dl.crc_passed those that passed."""
    _, out, snap, _, n = traced
    frames = [f for chunk in out for f in chunk]
    checked = [f.crc_ok for f in frames if f.crc_ok is not None]
    assert snap["counters"] == {
        "viterbi.steps": n["steps"], "viterbi.blocks": n["blocks"],
        "viterbi.kernel": 0, "dl.slots": len(frames),
        "dl.crc_checked": len(checked), "dl.crc_passed": sum(checked)}
    assert 0 < sum(checked) < len(checked)


def test_profiler_holds_the_chunk_spans_and_no_inner_span(traced):
    *_, names, _ = traced
    assert names.count("tetra.downlink") == 2
    assert names.count("tetra.downlink.demod") == 2
    assert not set(INNER) & set(names)


@pytest.mark.parametrize("metric", READERS)
def test_reader_returns_nothing_on_an_empty_record(metric):
    metrics.RECORDER._reset()
    assert harness.reader(metric)({}) is None


def test_traced_harness_run_reads_the_seven_metrics():
    """harness.run of the cell at the CPU's size, traced: the eight
    downlink metrics of the program's record, each within the others as
    their spans are, and on the CPU no block through the kernel."""
    cell = harness.Cell("dl.multiframe")
    cell.params.update(slots=24, ring_chunks=2)
    result, _ = harness.run(cell, 2**31 + 7, 1.0, True, "cpu", 0.0)
    m = {k: v["value"] for k, v in result["metrics"].items()}
    assert set(m) == set(READERS), m
    assert (m["dl.acquire.ms"] + m["dl.channel.ms"] + m["dl.assemble.ms"]
            <= m["dl.decode.ms"])
    assert m["dl.viterbi.ms"] <= m["dl.acquire.ms"] + m["dl.channel.ms"]
    assert m["dl.demod.ms"] > 0 and 0 < m["dl.crc_yield"] <= 100
    assert m["dl.viterbi_kernel_share"] == 0


@pytest.mark.parametrize("counters, share", [
    ({"viterbi.blocks": 40, "viterbi.kernel": 40}, 100.0),
    ({"viterbi.blocks": 40, "viterbi.kernel": 10}, 25.0),
    ({"viterbi.blocks": 40}, None),
    ({"viterbi.blocks": 0, "viterbi.kernel": 0}, None)])
def test_kernel_share_reader(monkeypatch, counters, share):
    """dl.viterbi_kernel_share is 100 x viterbi.kernel / viterbi.blocks;
    a record without the kernel's counter (a program without the kernel)
    or without blocks gives nothing."""
    monkeypatch.setattr(metrics, "snapshot", lambda: {
        "chunks": {"tetra.downlink": 2}, "spans": {}, "counters": counters,
        "records": []})
    assert harness.reader("dl.viterbi_kernel_share")({}) == share
