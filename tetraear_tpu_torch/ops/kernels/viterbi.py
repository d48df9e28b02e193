"""The K = 5 Viterbi in one launch (`csrc/viterbi.cu`): every trellis
step and the traceback of every code block of a call.

It replaces no TPU kernel: the JAX package runs a `lax.scan`
(`tetraear_tpu/ops/viterbi.py:141, 154`), and the plain version,
`ops.viterbi.viterbi_decode_plain`, a Python loop of about 15 launches a
trellis step.  `ops.viterbi.viterbi_decode` routes a CUDA tensor here and
a CPU tensor to the plain version; this wrapper takes only what the
kernel takes and raises on anything else.  The source's note gives the
arithmetic it repeats bit for bit, its layout and its bound.
`LAUNCHES` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

LAUNCHES = {"viterbi": 0}

RATE_DEN = 4
MAX_STEPS = 341      # 8 code blocks' soft values and decisions in 48 KB


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    from tetraear_tpu_torch.ops.kernels import build
    lib, _report = build("viterbi")
    fn = lib.tetra_viterbi
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    lib.tetra_cuda_error_string.restype = ctypes.c_char_p
    lib.tetra_cuda_error_string.argtypes = [ctypes.c_int]
    return lib


def viterbi(llrs: torch.Tensor, num_input_bits: int,
            terminated: bool = True) -> torch.Tensor:
    """The kernel: llrs (B, 4 N) contiguous float32 on a CUDA card, > 0
    meaning bit 1, punctured positions 0 -> (B, N - 4) uint8 message bits
    when `terminated` (the path ends in state 0, tail stripped), else
    (B, N) (the path ends in the best state, the first on ties); N up
    to MAX_STEPS, which holds the port's longest code (TCH/4.8, 292).
    One launch on the current stream, no sync; B = 0 launches nothing."""
    n = num_input_bits
    if n > MAX_STEPS:
        raise ValueError(f"viterbi: N = {n} trellis steps; the kernel's "
                         f"shared memory holds up to {MAX_STEPS}")
    if llrs.device.type != "cuda":
        raise ValueError(f"viterbi: llrs on {llrs.device}; the kernel takes "
                         "a CUDA tensor")
    if llrs.dtype != torch.float32 or not llrs.is_contiguous():
        raise ValueError("viterbi: llrs must be contiguous float32, got "
                         f"{llrs.dtype} with strides {llrs.stride()}")
    if llrs.dim() != 2 or n < 1 or llrs.shape[1] != RATE_DEN * n:
        raise ValueError(f"viterbi: llrs must be (B, {RATE_DEN} x N) with "
                         f"N = {n} >= 1, got {tuple(llrs.shape)}")
    n_out = n - 4 if terminated else n
    if n_out < 0:
        raise ValueError(f"viterbi: a terminated code of N = {n} < 4 steps")
    bsz = llrs.shape[0]
    out = torch.empty((bsz, n_out), dtype=torch.uint8, device=llrs.device)
    if bsz == 0:
        return out
    lib = _library()
    with torch.cuda.device(llrs.device):
        stream = torch.cuda.current_stream(llrs.device).cuda_stream
        err = lib.tetra_viterbi(llrs.data_ptr(), bsz, n, n_out,
                                int(terminated), out.data_ptr(), stream)
    if err:
        raise RuntimeError("viterbi: launch failed: "
                           + lib.tetra_cuda_error_string(err).decode())
    LAUNCHES["viterbi"] += 1
    return out
