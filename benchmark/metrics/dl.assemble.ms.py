"""dl.assemble.ms: the host assembly per chunk, the sum over a chunk of the
program's inner spans `dl.assemble` (the loop in slot order: MAC and
layer-3 parses, the call ledger).  A program without the span gives
nothing."""

from benchmark import program_spans


def read(trace):
    snap = program_spans.snapshot("tetra.downlink")
    if snap is None or "dl.assemble" not in snap["spans"]:
        return None
    return program_spans.per_chunk_ms("dl.assemble", "tetra.downlink")
