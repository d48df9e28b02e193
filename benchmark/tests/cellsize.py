"""A cell cut to a size the CPU runs in seconds: the chunk, the ring and
the busy carriers are smaller; every width of the configuration is
kept.  A cell held out of BENCHMARK.json (its cell file kept) is found
by its name, <config>.<traffic>."""

import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
TINY = {"chunk": 131072, "ring_chunks": 3}


def tiny_cell(name: str, busy: int):
    from benchmark import harness
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    if name not in {w["name"] for w in spec["workloads"]}:
        config, traffic = name.split(".")
        spec["workloads"].append({"name": name, "config": config,
                                  "traffic": traffic, "chips": 1})
    cell = harness.Cell(name, spec)
    cell.params.update(TINY, busy_carriers=busy)
    return cell
