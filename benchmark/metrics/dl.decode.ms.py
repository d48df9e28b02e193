"""dl.decode.ms: the downlink's host half per chunk, the mean of the
program's chunk span `tetra.downlink` (each `DownlinkReceiver.decode`
call: the pull of the soft bits, acquisition, the AACH, the channel
decodes and the layer-3 parse).  A program without the span gives
nothing."""

from benchmark import program_spans


def read(trace):
    snap = program_spans.snapshot("tetra.downlink")
    if snap is None or "tetra.downlink" not in snap["spans"]:
        return None
    return program_spans.per_chunk_ms("tetra.downlink", "tetra.downlink")
