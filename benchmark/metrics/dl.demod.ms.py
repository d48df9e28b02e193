"""dl.demod.ms: the downlink's device half per chunk, the mean of the
program's chunk span `tetra.downlink.demod` (each
`DownlinkReceiver.demodulate` call): the host time the call holds, the
copy of the chunk to the card and the etsi demod's launches.  A program
without the span gives nothing."""

from benchmark import program_spans


def read(trace):
    snap = program_spans.snapshot("tetra.downlink.demod")
    if snap is None or "tetra.downlink.demod" not in snap["spans"]:
        return None
    return program_spans.per_chunk_ms("tetra.downlink.demod",
                                      "tetra.downlink.demod")
