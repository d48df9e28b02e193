"""The sync walk of every row of a frontend result in one launch
(`csrc/sync_walk.cu`): each row's largest valid score, its threshold,
and the greedy walk over the hits.

It replaces no TPU kernel: the JAX package walks each row on the host in
numpy (`TetraDecoder.find_sync`'s cascade), and so did the port until
the walk came here, where the frontend leaves the scores.  The plain
version, `ops.sync.sync_walk_plain`, gives the rule and its derivation;
`ops.sync.sync_walk` routes a CUDA tensor here and a CPU tensor to the
plain version.  This wrapper takes only what the kernel takes and raises
on anything else.  The source's note gives the layout and the bound.
`LAUNCHES` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tetraear_tpu_torch import constants as C

LAUNCHES = {"sync_walk": 0}


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    from tetraear_tpu_torch.ops.kernels import build
    lib, _report = build("sync_walk")
    fn = lib.tetra_sync_walk
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p]
    lib.tetra_cuda_error_string.restype = ctypes.c_char_p
    lib.tetra_cuda_error_string.argtypes = [ctypes.c_int]
    return lib


def sync_walk(corr: torch.Tensor, count: torch.Tensor) -> tuple:
    """The kernel: corr (R, W) contiguous float32 and count (R,) int32 on
    one CUDA card -> (positions (R, ceil(W / 250)) int32, each row's
    accepted sync positions in order and -1 after them; accepted (R,)
    int32), as `ops.sync.sync_walk_plain` gives them.  One launch on the
    current stream, no sync; R = 0 or W = 0 launches nothing."""
    if corr.device.type != "cuda":
        raise ValueError(f"sync_walk: scores on {corr.device}; the kernel "
                         "takes a CUDA tensor")
    if count.device != corr.device:
        raise ValueError(f"sync_walk: count on {count.device}, scores on "
                         f"{corr.device}")
    if corr.dtype != torch.float32 or not corr.is_contiguous():
        raise ValueError("sync_walk: scores must be contiguous float32, got "
                         f"{corr.dtype} with strides {corr.stride()}")
    if count.dtype != torch.int32 or not count.is_contiguous():
        raise ValueError("sync_walk: count must be contiguous int32, got "
                         f"{count.dtype} with strides {count.stride()}")
    if corr.dim() != 2 or count.shape != corr.shape[:1]:
        raise ValueError("sync_walk: scores (R, W) and count (R,), got "
                         f"{tuple(corr.shape)} and {tuple(count.shape)}")
    rows, width = corr.shape
    cap = -(-width // C.SYNC_SKIP_BITS)
    positions = torch.empty((rows, cap), dtype=torch.int32,
                            device=corr.device)
    if rows == 0 or width == 0:
        return positions, torch.zeros(rows, dtype=torch.int32,
                                      device=corr.device)
    accepted = torch.empty(rows, dtype=torch.int32, device=corr.device)
    lib = _library()
    with torch.cuda.device(corr.device):
        stream = torch.cuda.current_stream(corr.device).cuda_stream
        err = lib.tetra_sync_walk(corr.data_ptr(), count.data_ptr(), rows,
                                  width, cap, positions.data_ptr(),
                                  accepted.data_ptr(), stream)
    if err:
        raise RuntimeError("sync_walk: launch failed: "
                           + lib.tetra_cuda_error_string(err).decode())
    LAUNCHES["sync_walk"] += 1
    return positions, accepted
