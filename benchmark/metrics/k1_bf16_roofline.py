"""k1_bf16_roofline: K1 bf16's share of its roofline, the least time the
card could take for one call (kernels/k1_bf16.py's FLOP over the peak
bf16 rate, or its bytes over the peak bandwidth, whichever is longer)
over the kernel's mean device time per call in the profiler's trace."""

from benchmark import profiling
from benchmark.kernels import k1_bf16


def read(trace):
    hits = [(t, n) for name, t, n in trace["device_ops"]
            if k1_bf16.DEVICE_NAME in name]
    peaks = next((v for k, v in trace["peaks"].items()
                  if k != "source" and trace["device"]["kind"].startswith(k)),
                 None)
    if not hits or peaks is None:
        return None
    seconds = sum(t for t, _ in hits) / sum(n for _, n in hits)
    least, _ = profiling.least_time(
        *k1_bf16.work(trace["config"], trace["params"]),
        peaks["bf16_flops"], peaks["hbm_bytes_per_s"])
    return 100.0 * least / seconds
