"""device.idle: the share of the traced window in which no operation ran
on the card, 1 - (union of the device operations' intervals) / window,
from the profiler's trace."""


def read(trace):
    dev = trace["device"]
    if not dev.get("busy_s"):
        return None
    return 100.0 * (1.0 - dev["busy_s"] / dev["window_s"])
