"""chunk_p95: the 95th percentile, over every chunk completed in the
window, of the time from its hand-off to the system until its answers
were out of the host stage, in ms."""

import numpy as np


def read(trace):
    lat = trace["latencies_s"]
    return float(np.percentile(lat, 95)) * 1e3 if lat else None
