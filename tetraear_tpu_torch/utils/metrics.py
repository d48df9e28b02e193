"""Throughput metrics and profiling hooks (port of
`tetraear_tpu.utils.metrics`).

Per-block samples/s counters for the receive loop (`ThroughputMeter`,
the reference's copy) and a context manager that records a
`torch.profiler` trace of a region (`profile_trace`; the reference wraps
`jax.profiler`).
"""

from __future__ import annotations

import contextlib
import logging
import time
from pathlib import Path
from typing import Dict, Optional

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


@contextlib.contextmanager
def profile_trace(trace_dir: Optional[str]):
    """Record a torch.profiler trace (CPU and, where a card is present,
    CUDA activity) of the region and write it as a Chrome trace,
    `trace_dir/trace.json` (open in Perfetto or chrome://tracing).

    No-op when trace_dir is None.  A profiler that cannot start is
    logged and the region runs untraced, as in the reference."""
    if not trace_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
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
