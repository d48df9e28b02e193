"""The spans and counters of the port's wideband decode
(`tetraear_tpu_torch.utils.metrics`), on the CPU: they are recorded
exactly while a torch.profiler session runs and change no output; chunk
spans nest and carry their chunk, inner spans stay out of the profiler;
the benchmark's readers find them in a traced window; `decode
--trace-dir` writes them beside the trace."""

import contextlib
import json
import re

import numpy as np
import pytest
import torch

from benchmark import harness
from tetraear_tpu_torch.core import decoder as decoder_mod
from tetraear_tpu_torch.models import candidates, multicarrier
from tetraear_tpu_torch.ops.channelizer import carrier_grid
from tetraear_tpu_torch.ui import cli
from tetraear_tpu_torch.utils import metrics

CELLS = [("fb96.dense", 6), ("wb16.quiet", 2)]
CHUNK_SPANS = ("tetra.frontend", "tetra.frontend.h2d",
               "tetra.frontend.channelize", "tetra.frontend.demod",
               "tetra.frontend.candidates", "tetra.decode",
               "tetra.decode.pull", "tetra.decode.rows")
INNER_SPANS = ("sync", "frame", "frame.batch")
COUNTERS = ("sync.passes", "frame.tried", "frame.passed", "frame.batched")
READERS = ("host_decode.wait.ms", "host_decode.sync.ms",
           "host_decode.frame.ms", "host_decode.frame_yield",
           "frontend.host.ms", "frontend.h2d.ms",
           "host_decode.frame_batch.ms")


def _cell(name, busy):
    """A benchmark cell at the CPU's size: 131,072-sample chunks, a ring
    of 3, every width of the configuration kept."""
    cell = harness.Cell(name)
    cell.params.update(chunk=131072, ring_chunks=3, busy_carriers=busy)
    return cell


def _profile():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


class _Run:
    """The benchmark's driver over a tiny ring, pipelined as the CLI's
    loop: chunk i + 1 handed to the frontend before chunk i's decode."""

    def __init__(self, name, busy):
        self.cell = _cell(name, busy)
        self.ring = self.cell.driver.make_ring(
            self.cell.config, self.cell.params, 2**31 + 5, "cpu")

    def loop(self, chunks=None):
        """-> (host copies of the frontend results, frames) per chunk,
        from a fresh system."""
        system = self.cell.driver.System(self.cell.config, "cpu")
        results, frames = [], []
        pending, start = None, 0
        for x in self.ring.chunks[:chunks]:
            res = system.submit(x, start)
            start += len(x)
            results.append(self.cell.driver.to_host(res))
            if pending is not None:
                frames.append(system.complete(pending))
            pending = res
        frames.append(system.complete(pending))
        return results, frames


def _same(a, b):
    """Equal results and frames: every array, key and value."""
    (ra, fa), (rb, fb) = a, b
    assert len(ra) == len(rb) and len(fa) == len(fb)
    for x, y in zip(ra, rb):
        assert x.keys() == y.keys()
        for k in x:
            np.testing.assert_array_equal(x[k], y[k], err_msg=k)
    for x, y in zip(fa, fb):
        for rows_a, rows_b in zip(x, y):
            assert len(rows_a) == len(rows_b)
            for f, g in zip(rows_a, rows_b):
                assert f.keys() == g.keys()
                for k in f:
                    if isinstance(f[k], np.ndarray):
                        np.testing.assert_array_equal(f[k], g[k])
                    else:
                        assert f[k] == g[k], k


def _calls(monkeypatch):
    """Count every find_sync call, every slot's frame decode
    (`decode_slot`) and the frames it returns, and the batches
    (`read_slots`) and their slots."""
    n = {"sync": 0, "tried": 0, "passed": 0, "batches": 0, "batched": 0}
    find_sync = decoder_mod.TetraDecoder.find_sync
    decode_slot = decoder_mod.TetraDecoder.decode_slot
    read_slots = decoder_mod.read_slots

    def counted_sync(self, *a, **k):
        n["sync"] += 1
        return find_sync(self, *a, **k)

    def counted_frame(self, *a, **k):
        n["tried"] += 1
        out = decode_slot(self, *a, **k)
        n["passed"] += bool(out)
        return out

    def counted_batch(head, symbols):
        n["batches"] += 1
        n["batched"] += len(head)
        return read_slots(head, symbols)
    monkeypatch.setattr(decoder_mod.TetraDecoder, "find_sync", counted_sync)
    monkeypatch.setattr(decoder_mod.TetraDecoder, "decode_slot",
                        counted_frame)
    monkeypatch.setattr(decoder_mod, "read_slots", counted_batch)
    return n


@pytest.fixture(scope="module", params=CELLS, ids=[c for c, _ in CELLS])
def traced(request):
    """An untraced run, then the same ring under a CPU profiler session:
    (run, untraced output, traced output, snapshot, profiler event
    names, calls counted)."""
    run = _Run(*request.param)
    plain = run.loop()
    with pytest.MonkeyPatch.context() as mp:
        n = _calls(mp)
        with _profile() as prof:
            out = run.loop()
    names = [e.name for e in prof.events()]
    return run, plain, out, metrics.snapshot(), names, n


def test_profiler_flag_is_the_switch():
    """The recorder reads torch's own flag,
    torch.autograd.profiler._is_profiler_enabled: off before a session,
    on inside it, off after.  A torch that moves the flag fails here."""
    flag = torch.autograd.profiler
    assert flag._is_profiler_enabled is False and not metrics.tracing()
    with _profile():
        assert flag._is_profiler_enabled is True and metrics.tracing()
    assert flag._is_profiler_enabled is False and not metrics.tracing()


def test_off_enters_no_record_function(monkeypatch):
    """Outside a session a span enters no record_function and records
    nothing."""
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    metrics.RECORDER._reset()
    with metrics.span("tetra.decode"):
        assert not metrics.tracing()
    assert metrics.snapshot()["records"] == []


@pytest.mark.parametrize("name,busy", CELLS, ids=[c for c, _ in CELLS])
def test_off_records_nothing_and_changes_nothing(name, busy, monkeypatch):
    """With no profiler the record stays empty, and frames, bits and
    candidates equal a run with the recorder's code path taken out."""
    run = _Run(name, busy)
    metrics.RECORDER._reset()
    plain = run.loop()
    snap = metrics.snapshot()
    assert (snap["chunks"], snap["spans"], snap["counters"],
            snap["records"]) == ({}, {}, {}, [])
    for module in (multicarrier, candidates):
        monkeypatch.setattr(module, "span",
                            lambda name: contextlib.nullcontext())
    monkeypatch.setattr(decoder_mod, "tracing", lambda: False)
    _same(plain, run.loop())


def test_traced_output_is_identical(traced):
    _, plain, out, *_ = traced
    _same(plain, out)


def test_child_spans_lie_inside_their_parent(traced):
    """Every child chunk span lies inside its parent's interval and
    carries its chunk's sequence number; frontend call n and decode call
    n are chunk n."""
    run, _, _, snap, _, _ = traced
    records = snap["records"]
    n = len(run.ring.chunks)
    for root in ("tetra.frontend", "tetra.decode"):
        assert [r["chunk"] for r in records
                if r["name"] == root and r["parent"] is None] == list(range(n))
    assert snap["chunks"] == {"tetra.frontend": n, "tetra.decode": n}
    for r in records:
        assert r["start_ns"] <= r["end_ns"]
        if r["parent"] is not None:
            p = records[r["parent"]]
            assert p["start_ns"] <= r["start_ns"] <= r["end_ns"] <= p["end_ns"]
            assert r["chunk"] == p["chunk"]
            assert r["name"].startswith(p["name"] + ".")
    assert {r["name"] for r in records} == set(CHUNK_SPANS)
    # the inner spans are summed under the row loop
    for r in records:
        assert set(r["inner"]) <= (set(INNER_SPANS)
                                   if r["name"] == "tetra.decode.rows"
                                   else set())


def test_counters_count_the_calls(traced):
    """frame.passed equals the frames decode returned, frame.tried and
    sync.passes the slots' frame decodes and the find_sync calls,
    frame.batched the slots the batches took, which is every slot tried;
    the inner spans' calls equal them, one batch a chunk."""
    run, _, out, snap, _, n = traced
    frames = sum(len(rows) for chunk in out[1] for rows in chunk)
    assert frames > 0
    c = snap["counters"]
    assert c == {"sync.passes": n["sync"], "frame.tried": n["tried"],
                 "frame.passed": n["passed"], "frame.batched": n["batched"]}
    assert c["frame.passed"] == frames
    assert c["frame.batched"] == c["frame.tried"]
    assert snap["spans"]["sync"]["count"] == n["sync"]
    assert snap["spans"]["frame"]["count"] == n["tried"]
    assert (snap["spans"]["frame.batch"]["count"] == n["batches"]
            == len(run.ring.chunks))


def test_frame_batch_once_a_chunk_inside_the_rows(traced):
    """Each chunk's row loop holds one `frame.batch` call, and its
    `frame` time (batch and tail) is at least its batch's."""
    _, _, _, snap, _, _ = traced
    rows = [r for r in snap["records"] if r["name"] == "tetra.decode.rows"]
    assert rows
    for r in rows:
        assert r["inner"]["frame.batch"][1] == 1
        assert r["inner"]["frame"][0] >= r["inner"]["frame.batch"][0]
    spans = snap["spans"]
    assert spans["frame"]["total_ms"] >= spans["frame.batch"]["total_ms"]


def test_profiler_holds_chunk_spans_and_no_inner_span(traced):
    run, _, _, _, names, _ = traced
    n = len(run.ring.chunks)
    for name in CHUNK_SPANS:
        assert names.count(name) == n, name
    assert not set(INNER_SPANS) & set(names)


def test_a_second_session_starts_a_fresh_record():
    """The record is the last session's: readable after it ends, fresh
    when the next starts (once a span has seen no session between)."""
    run = _Run("wb16.quiet", 2)
    assert not metrics.tracing()
    with _profile():
        run.loop()
    first = metrics.snapshot()
    n = len(run.ring.chunks)
    assert first["chunks"] == {"tetra.frontend": n, "tetra.decode": n}
    run.loop()
    assert metrics.snapshot() == first
    with _profile():
        run.loop(chunks=1)
    second = metrics.snapshot()
    assert second["chunks"] == {"tetra.frontend": 1, "tetra.decode": 1}
    assert [r["chunk"] for r in second["records"]
            if r["parent"] is None] == [0, 0]


@pytest.mark.parametrize("metric", READERS)
def test_reader_returns_nothing_on_an_empty_record(metric):
    metrics.RECORDER._reset()
    assert harness.reader(metric)({}) is None


def test_traced_harness_run_reads_the_six_metrics():
    """harness.run, traced on the CPU: the six metrics of the program's
    record, each within what the benchmark's own clocks read."""
    result, _ = harness.run(_cell("fb96.dense", 6), 2**31 + 7, 1.0, True,
                            "cpu", 0.0)
    m = {k: v["value"] for k, v in result["metrics"].items()}
    assert set(READERS) <= set(m), m
    assert (m["host_decode.wait.ms"] + m["host_decode.sync.ms"]
            + m["host_decode.frame.ms"]) <= m["host_decode.ms"]
    assert 0 < m["host_decode.frame_batch.ms"] <= m["host_decode.frame.ms"]
    assert m["frontend.h2d.ms"] <= m["frontend.host.ms"]
    assert 0 < m["host_decode.frame_yield"] <= 100
    assert result["correct"], result["check"]
    labels = {k for k, _ in result["breakdown"]["idle_gaps"]}
    assert labels <= {"host_decode", "frontend", "other host work"}


@pytest.mark.parametrize("argv,chunk_spans", [
    (["--carriers", "16", "--conv", "s2d"], CHUNK_SPANS),
    ([], ()),
], ids=["wideband", "single"])
def test_decode_trace_dir(tmp_path, monkeypatch, capsys, argv, chunk_spans):
    """`decode --trace-dir DIR` writes the Chrome trace, holding the
    chunk spans, and spans.json, holding every span and counter (the
    single-carrier path has no chunk span: its sync passes and frame
    decodes stand apart)."""
    from tetraear_tpu_torch.io.replay import save_iq
    from tetraear_tpu_torch.utils import synth
    x = (synth.planted_wideband((3, 8, 12))[0] if argv
         else synth.planted_single("ref-compat", num_frames=8)[0])
    iq = tmp_path / "planted.cf32"
    save_iq(iq, x)
    monkeypatch.setenv("TETRAEAR_TPU_LOG_DIR", str(tmp_path / "logs"))
    trace = tmp_path / "trace"
    assert cli.main(["decode", str(iq), *argv, "--device", "cpu",
                     "-o", str(tmp_path / "f.jsonl"),
                     "--trace-dir", str(trace)]) == 0
    capsys.readouterr()
    events = json.loads((trace / "trace.json").read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert set(chunk_spans) <= names
    assert not {n for n in names if str(n).startswith("tetra.")} - set(
        chunk_spans)
    assert not set(INNER_SPANS) & names
    spans = json.loads((trace / "spans.json").read_text())
    assert set(spans["spans"]) == set(chunk_spans) | set(INNER_SPANS)
    assert set(spans["counters"]) == set(COUNTERS)
    if chunk_spans:
        assert spans["chunks"]["tetra.decode"] >= 1
        assert spans["spans"]["tetra.decode"]["per_chunk_ms"] > 0
    else:
        assert spans["chunks"] == {}
        assert spans["spans"]["sync"]["per_chunk_ms"] is None


FRONTEND_SPANS = CHUNK_SPANS[:5]
FRONTENDS = ([(conv, False) for conv in (
    "staged", "fused", "s2d", "s2d_of", "pallas", "pallas_bf16",
    "pallas_db", "pallas_of2", "pallas_of2_bf16")]
    + [(conv, True) for conv in (
        "gather", "fused", "s2d", "pallas", "pallas_bf16", "pallas_db")])


@pytest.mark.parametrize("conv,pfb", FRONTENDS,
                         ids=[f"{c}-{'pfb' if p else 'ddc'}"
                              for c, p in FRONTENDS])
def test_every_frontend_records_the_five_chunk_spans(conv, pfb):
    """Every frontend build_frontend makes runs the one forward: a call
    under a profiler session records each `tetra.frontend*` chunk span
    once, the four stages inside `tetra.frontend`, in order."""
    mc = multicarrier.build_frontend(conv, device="cpu", pfb=pfb,
                                     offsets_hz=carrier_grid(4),
                                     num_candidates=4)
    r = np.random.default_rng(3)
    x = ((r.standard_normal(20_000) + 1j * r.standard_normal(20_000))
         * 0.1).astype(np.complex64)
    metrics.RECORDER.on()               # no session: the next is fresh
    with _profile():
        res = mc(x, start_index=0)
    records = metrics.snapshot()["records"]
    assert [r["name"] for r in records] == list(FRONTEND_SPANS)
    assert [r["parent"] for r in records] == [None, 0, 0, 0, 0]
    assert all(r["end_ns"] is not None for r in records)
    assert isinstance(res, candidates.MulticarrierResult)


# build_frontend's refusals: (conv, pfb) -> the message it raises
REFUSALS = {
    ("gather", False):
        "conv 'gather' is not a variant of the 16-carrier frontend",
    ("nope", False): "unknown conv variant 'nope'; valid: staged, gather, "
                     "fused, s2d, s2d_of, pallas, pallas_bf16, pallas_db, "
                     "pallas_of<N>, pallas_of<N>_bf16",
    ("pallas_of", False): "unknown variant 'pallas_of'; valid: "
                          "pallas_of<N>, pallas_of<N>_bf16",
    ("pallas_of7", False): "K1-of: ich*fold = 20*7 = 140 > 128 (or fold "
                           "< 1); lower the fold for this decimation",
    ("pallas_of4_f16", False): "unknown variant 'pallas_of4_f16'; valid: "
                               "pallas_of<N>, pallas_of<N>_bf16",
    ("pallas_of<N>_bf16", False): "unknown variant 'pallas_of<N>_bf16'; "
                                  "valid: pallas_of<N>, pallas_of<N>_bf16",
    ("staged", True):
        "conv 'staged' is not a variant of the full-band frontend",
    ("s2d_of", True):
        "conv 's2d_of' is not a variant of the full-band frontend",
    ("pallas_of4_bf16", True):
        "conv 'pallas_of4_bf16' is not a variant of the full-band frontend",
    ("s2d_mono", True): "unknown conv variant 's2d_mono'; valid: staged, "
                        "gather, fused, s2d, s2d_of, pallas, pallas_bf16, "
                        "pallas_db, pallas_of<N>, pallas_of<N>_bf16",
}


@pytest.mark.parametrize("conv,pfb", list(REFUSALS),
                         ids=[f"{c}-{'pfb' if p else 'ddc'}"
                              for c, p in REFUSALS])
def test_build_frontend_refuses_with_its_message(conv, pfb):
    with pytest.raises(ValueError, match=re.escape(REFUSALS[conv, pfb])):
        multicarrier.build_frontend(conv, device="cpu", pfb=pfb,
                                    offsets_hz=carrier_grid(4))
