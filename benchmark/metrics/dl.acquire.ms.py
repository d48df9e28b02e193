"""dl.acquire.ms: cell acquisition per chunk, the sum over a chunk of the
program's inner spans `dl.acquire` (the STS matched filter and the BSCH
tries up to the anchor).  A program without the span gives nothing."""

from benchmark import program_spans


def read(trace):
    snap = program_spans.snapshot("tetra.downlink")
    if snap is None or "dl.acquire" not in snap["spans"]:
        return None
    return program_spans.per_chunk_ms("dl.acquire", "tetra.downlink")
