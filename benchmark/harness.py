"""One run of one cell: set-up, the measured window, the traced window's
reading, and the comparison that decides `correct`.

The loop is closed: a replay of a recorded capture as fast as the system
goes, as `decode -i capture.iq` replays a file.  Chunk i + 1 is handed to
the system before chunk i's result goes to its host stage, as the CLI's
loop pipelines them.  A chunk's latency runs from its hand-off until its
answers are out of the host stage; the rate counts the samples of every
chunk whose answers came out in the window over the window's wall time.

What belongs to one way of driving the program sits in its driver
(drivers/<driver>.py, named by the configuration's `driver` key):
  make_ring(cfg, params, seed, device) -> a ring: `chunks`, a list of
      host inputs (each with a len(), its samples), and whatever the
      driver's check needs to judge them;
  System(cfg, device): submit(chunk, start_index) -> result (its device
      work queued); complete(result) -> the host stage's answers;
  to_host(result) -> a host copy of what the check compares;
  check(cfg, ring, samples, device) -> (numbers compared, info), where
      samples holds (ring index, host copy, answers) per sampled chunk.
Every metric, end-to-end or per-layer, is read by metrics/<name>.py's
`read(trace)`: an end-to-end metric from the window's record (`run`), a
per-layer metric from the traced window's (`_read_trace`).
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import random
import time
from pathlib import Path

import numpy as np
import torch

from benchmark import compare, profiling, traffic

ROOT = Path(__file__).resolve().parents[1]
HERE = ROOT / "benchmark"
SPANS = ("frontend", "host_decode")
TRACE_S = 10.0      # a traced run profiles the first seconds of its window


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


class Cell:
    """A workload of BENCHMARK.json with its configuration file, its
    traffic file and its cell file (whose keys override the traffic's),
    each found by name."""

    def __init__(self, name: str, spec: dict | None = None,
                 root: Path = ROOT):
        self.spec = spec or load_json(root / "BENCHMARK.json")
        found = [w for w in self.spec["workloads"] if w["name"] == name]
        if not found:
            raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
        self.workload = found[0]
        self.name = name
        conf = [c for c in self.spec["configs"]
                if c["name"] == self.workload["config"]][0]
        self.config = load_json(root / conf["file"])
        here = root / "benchmark"
        self.params = load_json(here / "traffic"
                                / f"{self.workload['traffic']}.json")
        cell_file = here / "cells" / f"{name}.json"
        if cell_file.exists():
            self.params.update(load_json(cell_file))
        self.driver = importlib.import_module(
            f"benchmark.drivers.{self.config['driver']}")
        self.limits = {**self.config.get("limits", {}),
                       **self.params.get("limits", {})}

    def metrics(self, kind: str) -> list:
        """This cell's end_to_end or per_layer entries."""
        return [m for m in self.spec[kind]
                if self.name in m.get("workloads", [self.name])]


def reader(metric: str):
    """metrics/<metric>.py's `read(trace)`."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class _Tracer:
    """torch.profiler over the traced part of the window, its length the
    host span `window`."""

    def __init__(self, cuda: bool):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.__enter__()
        self.window = torch.profiler.record_function("window")
        self.window.__enter__()
        self.done = False

    def stop(self, device) -> None:
        self.window.__exit__(None, None, None)
        _sync(device)
        self.prof.__exit__(None, None, None)
        self.done = True


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run(cell: Cell, seed: int, seconds: float, trace: bool, device,
        t_start: float, system_factory=None, ring=None) -> tuple:
    """-> (result dict, [(number, value, limit, ok)]).  `system_factory`
    (cfg, device) puts another system in the program's place (a control
    or a planted fault); `ring`, made by the driver from `seed`, saves
    making it again."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    cfg, params = cell.config, cell.params
    parts = {"start_s": time.monotonic() - t_start}
    if ring is None:
        ring = cell.driver.make_ring(cfg, params, seed, device)
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    parts["ring_s"] = time.monotonic() - t_start - parts["start_s"]
    system = (system_factory or cell.driver.System)(cfg, device)
    parts["system_s"] = time.monotonic() - t_start - sum(parts.values())
    n_ring = len(ring.chunks)

    # warm-up: one pipelined pass over the ring, the only shapes there are
    start_index = 0
    pending = None
    for x in ring.chunks:
        res = system.submit(x, start_index)
        start_index += len(x)
        if pending is not None:
            system.complete(pending)
        pending = res
    system.complete(pending)
    _sync(device)
    parts["warmup_s"] = time.monotonic() - t_start - sum(parts.values())

    rng = random.Random(int(traffic.seed_rng(seed).integers(1 << 62)))
    keep = n_ring                # the sample of chunks compared afterwards
    sample = []
    lat, host_s, events, done_at = [], [], [], []
    done_samples = 0
    tracer = _Tracer(cuda) if trace else None
    setup_s = time.monotonic() - t_start
    cpu0 = time.thread_time()
    t0 = time.monotonic()
    deadline = t0 + seconds
    trace_end = t0 + min(seconds, TRACE_S)
    i = 0
    pending = None
    t_last = t0
    while True:
        x = ring.chunks[i % n_ring]
        t_hand = time.monotonic()
        if tracer:
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True)) if cuda else None
            with torch.profiler.record_function("frontend"):
                if ev:
                    ev[0].record()
                res = system.submit(x, start_index)
                if ev:
                    ev[1].record()
                    events.append(ev)
        else:
            res = system.submit(x, start_index)
        start_index += len(x)
        if pending is not None:
            p_res, p_hand, p_idx = pending
            t_dec = time.monotonic()
            if tracer:
                with torch.profiler.record_function("host_decode"):
                    frames = system.complete(p_res)
            else:
                frames = system.complete(p_res)
            t_last = time.monotonic()
            if tracer:
                host_s.append(t_last - t_dec)
            done_at.append(t_last)
            lat.append(t_last - p_hand)
            done_samples += len(ring.chunks[p_idx % n_ring])
            # a seeded uniform sample of the completed chunks (reservoir)
            if len(sample) < keep:
                sample.append((p_idx % n_ring, p_res, frames))
            else:
                j = rng.randrange(len(lat))
                if j < keep:
                    sample[j] = (p_idx % n_ring, p_res, frames)
        pending = (res, t_hand, i)
        if tracer and not tracer.done and t_last >= trace_end:
            tracer.stop(device)
        if t_last >= deadline:
            break
        i += 1
    window_s = t_last - t0
    # how much of the window the loop's thread had a core
    thread_cpu_share = (time.thread_time() - cpu0) / window_s
    if tracer and not tracer.done:
        tracer.stop(device)
    system.complete(pending[0])     # the chunk in flight, after the window
    _sync(device)
    attempted = len(lat) + 1
    device_info = {"platform": "gpu" if cuda else device.type,
                   "kind": (torch.cuda.get_device_name(device) if cuda
                            else device.type),
                   "count": 1,
                   "memory_peak_bytes": (torch.cuda.max_memory_allocated(
                       device) if cuda else 0)}

    result = {"correct": False, "attempted": attempted, "failed": 0}
    if trace:
        metrics, breakdown = _read_trace(cell, tracer.prof, events, host_s,
                                         device_info)
        result["metrics"] = metrics
        result["device"] = device_info
        result["breakdown"] = breakdown
    else:
        record = {"samples": done_samples, "window_s": window_s,
                  "latencies_s": lat, "setup_s": setup_s}
        result["metrics"] = _read(cell.metrics("end_to_end"), record)
        result["device"] = device_info
    del tracer, events

    # the comparison, once the window has closed and the program's state
    # is freed: host copies of the sampled results, then the reference
    samples = [(idx, cell.driver.to_host(r), frames)
               for idx, r, frames in sample]
    del sample, system, pending, res
    if cuda:
        torch.cuda.empty_cache()
    numbers, info = cell.driver.check(cfg, ring, samples, device)
    correct, lines = compare.judge(numbers, cell.limits)
    result["correct"] = bool(correct)
    ends = np.asarray(done_at) - t0
    quarters = np.histogram(ends, bins=4, range=(0.0, window_s))[0]
    result["info"] = {**info, "chunks_in_window": len(lat),
                      "window_s": window_s, "setup": parts,
                      "chunks_by_quarter": quarters.tolist(),
                      "thread_cpu_share": thread_cpu_share}
    result["check"] = {name: {"value": value, "limit": limit}
                       for name, value, limit, _ in lines}
    return result, lines


def _read(entries: list, trace: dict) -> dict:
    """Each metric its reader finds something for, with its unit."""
    metrics = {}
    for m in entries:
        value = reader(m["name"])(trace)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    return metrics


def _read_trace(cell: Cell, prof, events, host_s, device_info: dict
                ) -> tuple:
    """The per-layer metrics, busy_s / window_s into device_info, and the
    breakdown, from the profiler, the CUDA events and the host spans."""
    dev_events = profiling.device_events(prof, ("window",) + SPANS)
    spans = profiling.host_spans(prof, ("window",) + SPANS)
    (w0, w1), = spans.pop("window")
    busy_us, gaps = profiling.union([(s, e) for _, s, e in dev_events],
                                    w0, w1)
    device_info["busy_s"] = busy_us / 1e6
    device_info["window_s"] = (w1 - w0) / 1e6
    ops = profiling.ops_by_time(dev_events)
    idle = profiling.label_gaps(gaps, spans)
    trace = {"config": cell.config, "params": cell.params,
             "device": device_info, "device_ops": ops,
             "host_decode_s": host_s,
             "frontend_ms": [a.elapsed_time(b) for a, b in events],
             "peaks": load_json(HERE / "peaks.json")}
    metrics = _read(cell.metrics("per_layer"), trace)
    breakdown = {
        "device_ops": [[profiling.short(name), t] for name, t, _ in ops[:10]],
        "idle_gaps": sorted(([k, v] for k, v in idle.items()),
                            key=lambda kv: -kv[1])[:10]}
    return metrics, breakdown
