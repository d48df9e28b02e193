"""The harness is driven by data: a cell whose configuration names
another driver runs through `harness.run` on that driver's own traffic,
with files and a driver module only, and every metric, end-to-end or
per-layer, has its reader file."""

import json
import sys
import types

import numpy as np
import pytest

from cellsize import ROOT

from benchmark import harness

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())


def _echo_driver():
    """A driver whose system returns each chunk's sum and whose traffic
    is a ring of seeded constant chunks, of two lengths."""
    mod = types.ModuleType("benchmark.drivers._echo")

    class Ring:
        def __init__(self, params, seed):
            rng = np.random.default_rng(seed)
            self.chunks = [np.full(int(params["chunk"]) * (1 + i % 2),
                                   rng.integers(1, 9), np.int64)
                           for i in range(int(params["ring_chunks"]))]

    class System:
        def __init__(self, cfg, device):
            pass

        def submit(self, x, start_index):
            return int(x.sum())

        def complete(self, result):
            return result

    def check(cfg, ring, samples, device):
        wrong = sum(int(ring.chunks[i].sum()) != got
                    for i, _, got in samples)
        return {"frames_diff": wrong}, {"chunks_checked": len(samples)}

    mod.make_ring = lambda cfg, params, seed, device: Ring(params, seed)
    mod.System = System
    mod.to_host = lambda result: result
    mod.check = check
    return mod


def test_a_new_driver_brings_its_own_traffic(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "benchmark.drivers._echo",
                        _echo_driver())
    (tmp_path / "benchmark" / "traffic").mkdir(parents=True)
    (tmp_path / "echo.json").write_text(json.dumps({"driver": "_echo"}))
    (tmp_path / "benchmark" / "traffic" / "flat.json").write_text(
        json.dumps({"chunk": 64, "ring_chunks": 4}))
    spec = {**SPEC,
            "configs": [{"name": "echo", "file": "echo.json"}],
            "workloads": [{"name": "echo.flat", "config": "echo",
                           "traffic": "flat", "chips": 1, "why": "test"}],
            "end_to_end": [{**m, "workloads": ["echo.flat"]}
                           for m in SPEC["end_to_end"]]}
    cell = harness.Cell("echo.flat", spec, root=tmp_path)
    result, lines = harness.run(cell, 5, 0.2, False, "cpu", 0.0)
    assert result["correct"] and lines == [("frames_diff", 0, 0, True)]
    m = result["metrics"]
    assert set(m) == {e["name"] for e in SPEC["end_to_end"]}
    # the rate counts each chunk's own length: 64 or 128 samples
    chunks = result["info"]["chunks_in_window"]
    assert 64 * chunks <= m["iq_rate"]["value"] * result["info"][
        "window_s"] <= 128 * chunks


@pytest.mark.parametrize("metric", SPEC["end_to_end"] + SPEC["per_layer"],
                         ids=lambda m: m["name"])
def test_every_metric_has_its_reader(metric):
    assert callable(harness.reader(metric["name"]))


def test_a_reader_with_nothing_to_read_returns_nothing():
    empty = {"samples": 0, "window_s": 0.0, "latencies_s": [],
             "setup_s": 1.0, "host_decode_s": [], "frontend_ms": [],
             "device": {}, "device_ops": []}
    for name in ("iq_rate", "chunk_p95", "host_decode.ms", "frontend.ms",
                 "device.idle"):
        assert harness.reader(name)(empty) is None
