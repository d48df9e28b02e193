"""BENCHMARK.json keeps to the contract's shape, and every file a cell,
configuration or metric needs is found by its name."""

import json
import re

import pytest

from cellsize import ROOT

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_size():
    assert set(SPEC) == TOP
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= SPEC["run_seconds"] <= 51
    assert isinstance(SPEC["run_seconds"], int)


def test_command_and_paths():
    assert 1 <= len(SPEC["command"]) <= 32
    assert all(_line(w) and not w.startswith("/") and ".." not in w
               for w in SPEC["command"])
    assert 1 <= len(SPEC["paths"]) <= 16
    for p in SPEC["paths"]:
        assert PATH.match(p) and not p.endswith("_torch")
        assert (ROOT / p).is_dir()
    under = [w for w in SPEC["command"] if "/" in w]
    assert all(any(w.startswith(p + "/") for p in SPEC["paths"])
               for w in under)


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end",
                                  "per_layer"])
def test_names_are_unique_and_well_formed(kind):
    names = [e["name"] for e in SPEC[kind]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


def test_metric_names_are_unique_across_kinds():
    names = [m["name"] for k in ("end_to_end", "per_layer") for m in SPEC[k]]
    assert len(names) == len(set(names))


@pytest.mark.parametrize("metric", SPEC["end_to_end"] + SPEC["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_fields(metric):
    assert UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    cells = {w["name"] for w in SPEC["workloads"]}
    assert set(metric.get("workloads", cells)) <= cells
    if "bound" in metric:
        assert set(metric) <= {"name", "unit", "better", "bound", "source",
                               "workloads"}
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert set(metric) <= {"name", "unit", "better", "source", "layer",
                               "moves", "workloads"}
        assert metric["source"] in ("device_trace", "program_span",
                                    "program_counter", "host_clock")
        assert _line(metric["layer"])
        assert metric["moves"] in {m["name"] for m in SPEC["end_to_end"]}
        if metric["name"].endswith("_roofline"):
            assert metric["unit"] == "%"
        assert (ROOT / "benchmark" / "metrics"
                / f"{metric['name']}.py").is_file()


def test_setup_is_an_end_to_end_metric():
    assert "setup_s" in {m["name"] for m in SPEC["end_to_end"]}


@pytest.mark.parametrize("cfg", SPEC["configs"], ids=lambda c: c["name"])
def test_config_files(cfg):
    assert set(cfg) == {"name", "source", "file", "reduced", "why"}
    assert _line(cfg["source"]) and _line(cfg["why"])
    assert len(cfg["reduced"]) <= 16
    assert all(NAME.match(k) for k in cfg["reduced"])
    assert any(cfg["file"].startswith(p + "/") for p in SPEC["paths"])
    body = json.loads((ROOT / cfg["file"]).read_text())
    assert body["name"] == cfg["name"]
    assert body["reduced"] == cfg["reduced"]
    assert (ROOT / "benchmark" / "drivers"
            / f"{body['driver']}.py").is_file()
    files = [c["file"] for c in SPEC["configs"]]
    assert files.count(cfg["file"]) == 1
    assert any(w["config"] == cfg["name"] for w in SPEC["workloads"])


@pytest.mark.parametrize("wl", SPEC["workloads"], ids=lambda w: w["name"])
def test_workloads(wl):
    assert set(wl) == {"name", "config", "traffic", "chips", "why"}
    assert wl["chips"] in (1, 4)
    assert _line(wl["why"])
    assert NAME.match(wl["traffic"]) and NAME.match(wl["config"])
    assert wl["config"] in {c["name"] for c in SPEC["configs"]}
    assert (ROOT / "benchmark" / "traffic"
            / f"{wl['traffic']}.json").is_file()
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert pairs.count((wl["config"], wl["traffic"])) == 1
    # every cell reports setup_s, another end-to-end metric and a
    # per-layer metric
    e2e = [m["name"] for m in SPEC["end_to_end"]
           if wl["name"] in m.get("workloads", [wl["name"]])]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert any(wl["name"] in m.get("workloads", [wl["name"]])
               for m in SPEC["per_layer"])


def test_four_chip_cells_are_few():
    four = sum(w["chips"] == 4 for w in SPEC["workloads"])
    assert four <= max(1, len(SPEC["workloads"]) // 4)


@pytest.mark.parametrize("wl", SPEC["workloads"], ids=lambda w: w["name"])
def test_harness_finds_each_cell(wl):
    from benchmark import harness
    cell = harness.Cell(wl["name"])
    assert cell.params["chunk"] > 0 and cell.params["busy_carriers"] > 0
    assert {m["name"] for m in cell.metrics("per_layer")}
    for m in cell.metrics("per_layer"):
        assert callable(harness.reader(m["name"]))


def test_files_under_paths_are_named_from_name_characters():
    for p in SPEC["paths"]:
        for f in (ROOT / p).rglob("*"):
            if "__pycache__" in f.parts:
                continue
            rel = f.relative_to(ROOT).as_posix()
            assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel
