"""setup_s: process start to the first timed chunk (imports, the card's
start, the traffic, the system built, the warm-up pass)."""


def read(trace):
    return trace["setup_s"]
