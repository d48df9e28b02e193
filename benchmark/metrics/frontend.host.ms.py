"""frontend.host.ms: the frontend call's mean host time per chunk, the
program's span `tetra.frontend` (`MulticarrierFrontend.forward`): the
part of a chunk's period the frontend holds the host, its pageable copy
and its launches."""

from benchmark import program_spans


def read(trace):
    return program_spans.per_chunk_ms("tetra.frontend", "tetra.frontend")
