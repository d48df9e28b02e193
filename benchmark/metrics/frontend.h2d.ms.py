"""frontend.h2d.ms: the chunk copy's mean host time per chunk, the
program's span `tetra.frontend.h2d` (`torch.as_tensor(x, device=...)
.to(complex64)` of the host chunk: a pageable copy, which blocks the
host)."""

from benchmark import program_spans


def read(trace):
    return program_spans.per_chunk_ms("tetra.frontend.h2d", "tetra.frontend")
