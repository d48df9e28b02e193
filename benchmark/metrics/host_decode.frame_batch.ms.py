"""host_decode.frame_batch.ms: the batched stage of the frame decode per
chunk, the sum over a chunk of the program's inner spans `frame.batch`
(one `read_slots` call over every slot the chunk's sync walks found:
bursts sliced, soft CRCs checked, MAC headers read).  It lies inside
`frame` (host_decode.frame.ms).  A program without the span gives
nothing."""

from benchmark import program_spans


def read(trace):
    snap = program_spans.snapshot("tetra.decode")
    if snap is None or "frame.batch" not in snap["spans"]:
        return None
    return program_spans.per_chunk_ms("frame.batch", "tetra.decode")
