"""iq_rate: the IQ samples of every chunk whose answers came out of the
host stage in the window, over the window's wall time."""


def read(trace):
    if not trace["window_s"]:
        return None
    return trace["samples"] / trace["window_s"]
