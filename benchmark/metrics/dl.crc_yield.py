"""dl.crc_yield: the share of the downlink's CRC-checked slots whose CRC
passed, 100 x the program's counters `dl.crc_passed` / `dl.crc_checked`
over the traced window.  A program without the counters gives nothing."""

from benchmark import program_spans


def read(trace):
    snap = program_spans.snapshot("tetra.downlink")
    if snap is None:
        return None
    checked = snap["counters"].get("dl.crc_checked", 0)
    return (100.0 * snap["counters"].get("dl.crc_passed", 0) / checked
            if checked else None)
