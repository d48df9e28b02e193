"""Throughput metrics and profiling hooks (port of
`tetraear_tpu.utils.metrics`).

Per-block samples/s counters for the receive loop (`ThroughputMeter`,
the reference's copy), a context manager that records a `torch.profiler`
trace of a region (`profile_trace`; the reference wraps `jax.profiler`),
and the spans and counters of the wideband decode (`span`, `record`,
`snapshot`), recorded while a `torch.profiler` session runs.
"""

from __future__ import annotations

import contextlib
import json
import logging
import threading
import time
from pathlib import Path
from typing import Dict, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

logger = logging.getLogger(__name__)


class ThroughputMeter:
    """Sliding-window samples/s + frames/s counters for the capture loop."""

    def __init__(self, window_s: float = 10.0, clock=time.monotonic):
        self.window_s = window_s
        self._clock = clock
        self._events: list = []          # (t, samples, frames)
        self.total_samples = 0
        self.total_frames = 0
        self._start = clock()

    def record(self, samples: int, frames: int = 0) -> None:
        now = self._clock()
        self._events.append((now, samples, frames))
        self.total_samples += samples
        self.total_frames += frames
        cutoff = now - self.window_s
        while self._events and self._events[0][0] < cutoff:
            self._events.pop(0)

    def rates(self) -> Dict[str, float]:
        now = self._clock()
        if not self._events:
            return {"samples_per_sec": 0.0, "frames_per_sec": 0.0,
                    "realtime_factor": 0.0}
        span = max(now - self._events[0][0], 1e-9)
        samples = sum(e[1] for e in self._events)
        frames = sum(e[2] for e in self._events)
        sps = samples / span
        return {"samples_per_sec": sps,
                "frames_per_sec": frames / span,
                "realtime_factor": sps / 2.4e6}

    def summary(self) -> str:
        elapsed = max(self._clock() - self._start, 1e-9)
        r = self.rates()
        return (f"{self.total_samples} samples, {self.total_frames} frames "
                f"in {elapsed:.1f}s | window: {r['samples_per_sec'] / 1e6:.2f} "
                f"MS/s ({r['realtime_factor']:.1f}x realtime), "
                f"{r['frames_per_sec']:.1f} frames/s")


class SpanRecorder:
    """The spans and counters of the decode path, recorded exactly while
    a torch.profiler session runs: the profiler's own flag,
    `torch.autograd.profiler._is_profiler_enabled`, is the switch.  Off,
    a span costs that one read.

    Chunk spans (`span`), a few a chunk, enter
    `torch.profiler.record_function`, so they lie on the profiler's clock
    beside the device operations, and are kept whole: name, start and end
    (`time.perf_counter_ns`), parent (its `id`), and the chunk's sequence
    number (the n-th root span of its name in the session; a child takes
    its parent's).  Inner spans (`record`), the calls a row makes, stay
    out of the profiler: their nanoseconds and calls are summed by name
    under the thread's innermost open chunk span, or apart where none is
    open.  The record starts afresh at the first span of a session whose
    previous span (or `on()` call) saw no session, and stays readable
    after the session until then; `profile_trace` calls `on()` before it
    starts its session."""

    def __init__(self):
        self._live = False
        self._lock = threading.Lock()
        self._local = threading.local()
        self._reset()

    def _reset(self) -> None:
        self.records: list = []
        self.loose: dict = {}        # inner spans outside any chunk span
        self.counters: dict = {}
        self._seq: dict = {}

    def on(self) -> bool:
        """Whether a profiler session runs (the first call in a new one
        starts a fresh record)."""
        if _autograd_profiler._is_profiler_enabled:
            if not self._live:
                self._reset()
                self._live = True
            return True
        self._live = False
        return False

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def span(self, name: str):
        """A chunk span over the `with` block."""
        return _ChunkSpan(self, name) if self.on() else _OFF

    def record(self, name: str, ns: int, calls: int,
               counters: Optional[dict] = None) -> None:
        """An inner span: `calls` calls of `name` that took `ns` in all,
        summed into the thread's innermost open chunk span (apart where
        none is open), and `counters` added to the session's."""
        stack = self._stack()
        with self._lock:
            total = (stack[-1]["inner"] if stack else self.loose).setdefault(
                name, [0, 0])
            total[0] += ns
            total[1] += calls
            for counter, n in (counters or {}).items():
                self.counters[counter] = self.counters.get(counter, 0) + n

    def snapshot(self) -> dict:
        """The record: `chunks`, the closed root chunk spans by name;
        `spans`, by name over chunk and inner spans alike, `total_ms`,
        `count` and `per_chunk_ms` (the total over the chunks of its root
        span; None outside any); `counters`; `records`, the chunk spans
        whole, their inner sums [ns, calls] by name included."""
        with self._lock:
            records = [dict(r, inner={k: list(v)
                                      for k, v in r["inner"].items()})
                       for r in self.records]
            loose = {k: list(v) for k, v in self.loose.items()}
            counters = dict(self.counters)
        chunks: dict = {}
        sums: dict = {}              # name -> [ns, calls, root name]

        def add(name, ns, calls, root):
            s = sums.setdefault(name, [0, 0, root])
            s[0] += ns
            s[1] += calls

        for r in records:
            if r["end_ns"] is None:
                continue
            root = r
            while root["parent"] is not None:
                root = records[root["parent"]]
            if r is root:
                chunks[r["name"]] = chunks.get(r["name"], 0) + 1
            add(r["name"], r["end_ns"] - r["start_ns"], 1, root["name"])
            for name, (ns, calls) in r["inner"].items():
                add(name, ns, calls, root["name"])
        for name, (ns, calls) in loose.items():
            add(name, ns, calls, None)
        spans = {name: {"total_ms": ns / 1e6, "count": calls,
                        "per_chunk_ms": (ns / 1e6 / chunks[root]
                                         if chunks.get(root) else None)}
                 for name, (ns, calls, root) in sums.items()}
        return {"chunks": chunks, "spans": spans, "counters": counters,
                "records": records}


class _ChunkSpan:
    __slots__ = ("rec", "name", "entry", "annotation")

    def __init__(self, rec: SpanRecorder, name: str):
        self.rec, self.name = rec, name

    def __enter__(self):
        rec = self.rec
        stack = rec._stack()
        self.annotation = torch.profiler.record_function(self.name)
        self.annotation.__enter__()
        with rec._lock:
            if stack:
                parent, chunk = stack[-1]["id"], stack[-1]["chunk"]
            else:
                parent, chunk = None, rec._seq.get(self.name, 0)
                rec._seq[self.name] = chunk + 1
            self.entry = {"name": self.name, "id": len(rec.records),
                          "parent": parent, "chunk": chunk, "inner": {},
                          "start_ns": time.perf_counter_ns(),
                          "end_ns": None}
            rec.records.append(self.entry)
        stack.append(self.entry)
        return self

    def __exit__(self, *exc):
        self.entry["end_ns"] = time.perf_counter_ns()
        self.rec._stack().pop()
        self.annotation.__exit__(*exc)
        return False


_OFF = contextlib.nullcontext()
RECORDER = SpanRecorder()
span = RECORDER.span
record = RECORDER.record
tracing = RECORDER.on
snapshot = RECORDER.snapshot


@contextlib.contextmanager
def profile_trace(trace_dir: Optional[str]):
    """Record a torch.profiler trace (CPU and, where a card is present,
    CUDA activity) of the region and write it as a Chrome trace,
    `trace_dir/trace.json` (open in Perfetto or chrome://tracing), and
    the session's span record (`snapshot()`) as `trace_dir/spans.json`.

    No-op when trace_dir is None.  A profiler that cannot start is
    logged and the region runs untraced, as in the reference."""
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    tracing()                    # no session yet: the next starts afresh
    try:
        prof.__enter__()
        logger.info("torch.profiler trace -> %s", trace_dir)
    except RuntimeError as e:
        logger.warning("profiler unavailable: %s", e)
        prof = None
    try:
        yield
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
            out = Path(trace_dir)
            out.mkdir(parents=True, exist_ok=True)
            prof.export_chrome_trace(str(out / "trace.json"))
            (out / "spans.json").write_text(json.dumps(snapshot()))
