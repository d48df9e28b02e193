"""host_decode.frame.ms: the frame decode's time per chunk, the sum over
a chunk of the program's inner spans `frame` (each
`TetraDecoder.decode_frame` call: burst parse, CRC, MAC PDU, SDS and
decrypt)."""

from benchmark import program_spans


def read(trace):
    return program_spans.per_chunk_ms("frame", "tetra.decode")
