"""dl.channel.ms: the channel decodes per chunk, the sum over a chunk of
the program's inner spans `dl.channel` (one batched decode per channel
group, BSCH, SCH/HD, SCH/F, STCH, TCH, their pulls included).  A program
without the span gives nothing."""

from benchmark import program_spans


def read(trace):
    snap = program_spans.snapshot("tetra.downlink")
    if snap is None or "dl.channel" not in snap["spans"]:
        return None
    return program_spans.per_chunk_ms("dl.channel", "tetra.downlink")
