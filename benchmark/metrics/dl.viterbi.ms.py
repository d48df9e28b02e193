"""dl.viterbi.ms: the Viterbi per chunk, the sum over a chunk of the
program's inner spans `viterbi` (each `ops/viterbi.viterbi_decode` call:
the host time of its launches); it overlaps `dl.acquire` and
`dl.channel`.  A program without the span gives nothing."""

from benchmark import program_spans


def read(trace):
    snap = program_spans.snapshot("tetra.downlink")
    if snap is None or "viterbi" not in snap["spans"]:
        return None
    return program_spans.per_chunk_ms("viterbi", "tetra.downlink")
