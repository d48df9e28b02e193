"""Reading a torch.profiler trace: device time by operation, the device's
busy time as the union of its operations' intervals, its idle gaps by
what the host was doing, and the least time a kernel could take.

Copied from chip_smoke.py: the device time by name of `_device_busy_ms`
(:866-883, key_averages' CUDA entries) and `_bound` (:934-940).
"""

from __future__ import annotations

import bisect

import torch


def device_events(prof, annotations=()) -> list:
    """(name, start_us, end_us) of every operation that ran on the
    device (kernels, copies, sets), in the profiler's time base; the
    device-side copies of host spans (`annotations`) are no operation."""
    cuda = torch.autograd.DeviceType.CUDA
    return [(e.name, e.time_range.start, e.time_range.end)
            for e in prof.events()
            if e.device_type == cuda and e.name not in annotations
            and not getattr(e, "is_user_annotation", False)]


def short(name: str, width: int = 96) -> str:
    """A kernel's name without its return type and argument list (a
    copy's name as it is), cut to `width` characters."""
    if name.endswith(")") and "::" in name:
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i]
                break
    return name.removeprefix("void ")[:width]


def host_spans(prof, names) -> dict:
    """name -> [(start_us, end_us)] of the host spans (record_function)
    with those names."""
    cpu = torch.autograd.DeviceType.CPU
    out = {n: [] for n in names}
    for e in prof.events():
        if e.device_type == cpu and e.name in out:
            out[e.name].append((e.time_range.start, e.time_range.end))
    return out


def union(intervals, lo: float, hi: float) -> tuple:
    """(covered length, gaps) of the intervals clipped to [lo, hi]."""
    covered = 0.0
    gaps = []
    cur = lo
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals
                       if e > lo and s < hi):
        if s > cur:
            gaps.append((cur, s))
        if e > cur:
            covered += e - max(s, cur)
            cur = e
    if cur < hi:
        gaps.append((cur, hi))
    return covered, gaps


def label_gaps(gaps, spans: dict, other: str = "other host work") -> dict:
    """Idle seconds by the host span that holds each gap's midpoint (the
    spans do not overlap one another)."""
    out = {}
    flat = sorted((s, e, name) for name, iv in spans.items()
                  for s, e in iv)
    starts = [s for s, _, _ in flat]
    for s, e in gaps:
        mid = (s + e) / 2
        i = bisect.bisect_right(starts, mid) - 1
        name = flat[i][2] if i >= 0 and flat[i][1] >= mid else other
        out[name] = out.get(name, 0.0) + (e - s) / 1e6
    return out


def ops_by_time(events) -> list:
    """[(name, seconds, calls)] of the device operations, most time
    first."""
    total = {}
    for name, s, e in events:
        t, n = total.get(name, (0.0, 0))
        total[name] = (t + (e - s) / 1e6, n + 1)
    return sorted(((k, t, n) for k, (t, n) in total.items()),
                  key=lambda r: -r[1])


def least_time(flops: float, nbytes: float, peak_flops: float,
               peak_bytes: float) -> tuple:
    """(seconds, "operations" | "bytes"): the least time the card could
    take, the operations at its peak rate or the bytes at its peak
    bandwidth, whichever is longer."""
    ops_s, bytes_s = flops / peak_flops, nbytes / peak_bytes
    return (ops_s, "operations") if ops_s >= bytes_s else (bytes_s, "bytes")
