"""The program's own record of the traced window: the spans and counters
that `tetraear_tpu_torch.utils.metrics` keeps while a torch.profiler
session runs (here, the harness's traced window), read after it with
`snapshot()`.  A program that keeps no such record gives nothing, and so
does a record that holds no chunk."""

from __future__ import annotations


def snapshot(root: str):
    """The program's record, or None where it has none or holds no
    closed `root` chunk span (`tetra.decode`, `tetra.frontend`)."""
    from tetraear_tpu_torch.utils import metrics
    read = getattr(metrics, "snapshot", None)
    snap = read() if read else None
    if not snap or not snap["chunks"].get(root):
        return None
    return snap


def per_chunk_ms(name: str, root: str):
    """Milliseconds of the spans `name` (chunk or inner) over the window,
    over its `root` chunks: a chunk's mean, or a chunk's sum for inner
    spans."""
    snap = snapshot(root)
    if snap is None:
        return None
    total = snap["spans"].get(name, {}).get("total_ms", 0.0)
    return total / snap["chunks"][root]
