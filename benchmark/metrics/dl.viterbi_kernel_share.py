"""dl.viterbi_kernel_share: the share of the downlink's Viterbi code
blocks that the hand-written kernel decoded, 100 x the program's counters
`viterbi.kernel` / `viterbi.blocks` over the traced window.  A program
without the `viterbi.kernel` counter gives nothing."""

from benchmark import program_spans


def read(trace):
    snap = program_spans.snapshot("tetra.downlink")
    if snap is None or "viterbi.kernel" not in snap["counters"]:
        return None
    blocks = snap["counters"].get("viterbi.blocks", 0)
    return (100.0 * snap["counters"]["viterbi.kernel"] / blocks
            if blocks else None)
