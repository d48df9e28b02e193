"""K1 bf16 (tetraear_tpu_torch/csrc/s2d_conv_tc.cu, `s2d_conv_tc_kernel`):
the composite channelizer conv, bf16 operands on the tensor cores.

Work of one call on a chunk of N samples: 2C output rows (re, im of C
carriers or channels), each of M = ceil(N / D) outputs a sum over 2
inputs (re, im) and the L taps the filter needs: 2 x 2C x 2 x L x M FLOP.
Bytes, each once: the complex64 chunk read (8 N), the bf16 weights read
(2 x 2C x 2 x L), the float32 rows written (4 x 2C x M).  L is the
yardstick's own design of the filter (benchmark/reference.py)."""

from benchmark import reference

DEVICE_NAME = "s2d_conv_tc_kernel"   # the kernel's name in the trace


def work(cfg: dict, params: dict) -> tuple:
    """(FLOP, bytes) of one call."""
    d = reference.design(cfg)
    rows = 2 * len(d["offsets"])
    taps = len(d["h"])
    n = int(params["chunk"])
    m = -(-n // d["decim"])
    flops = 2.0 * rows * 2 * taps * m
    nbytes = 8.0 * n + 2.0 * rows * 2 * taps + 4.0 * rows * m
    return flops, nbytes
