"""host_decode.sync_kernel_share: the share of the wideband decode's rows
whose sync walk the hand-written kernel ran, 100 x the program's counters
`sync.kernel` / `sync.rows` over the traced window.  A program without
the `sync.kernel` counter gives nothing."""

from benchmark import program_spans


def read(trace):
    snap = program_spans.snapshot("tetra.decode")
    if snap is None or "sync.kernel" not in snap["counters"]:
        return None
    rows = snap["counters"].get("sync.rows", 0)
    return 100.0 * snap["counters"]["sync.kernel"] / rows if rows else None
