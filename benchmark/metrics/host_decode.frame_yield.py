"""host_decode.frame_yield: the share of the sync positions the host
decode tried that gave a frame, 100 x the program's counters
`frame.passed` / `frame.tried` over the traced window."""

from benchmark import program_spans


def read(trace):
    snap = program_spans.snapshot("tetra.decode")
    if snap is None:
        return None
    tried = snap["counters"].get("frame.tried", 0)
    return (100.0 * snap["counters"].get("frame.passed", 0) / tried
            if tried else None)
