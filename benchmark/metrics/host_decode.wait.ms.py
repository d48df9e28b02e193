"""host_decode.wait.ms: the host decode's mean time per chunk in its
device-to-host pulls, the program's span `tetra.decode.pull` (the three
`.cpu()` calls at the top of `MulticarrierDecoder.decode`): host time
blocked on the card, which runs the next chunk's kernels queued ahead
of the copies, and the copies themselves."""

from benchmark import program_spans


def read(trace):
    return program_spans.per_chunk_ms("tetra.decode.pull", "tetra.decode")
