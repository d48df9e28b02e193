"""host_decode.sync.ms: the sync walk's time per chunk, the sum over a
chunk of the program's inner spans `sync` (each `TetraDecoder.find_sync`
pass of the threshold cascade, every row)."""

from benchmark import program_spans


def read(trace):
    return program_spans.per_chunk_ms("sync", "tetra.decode")
