"""Hand-written Hopper kernels and their build.

Each kernel's CUDA C++ source lives in `tetraear_tpu_torch/csrc/`, has a
plain C interface, and is compiled by `nvcc` for sm_90a into a shared
library under `<checkout>/build/kernels/` on first use, then loaded with
ctypes.  Nothing is built when a module is imported, so the package
imports (and its CPU tests run) on a machine without nvcc or a card.

Each kernel module keeps a `LAUNCHES` dict, wrapper name -> launches;
`launches()` and `reset_launches()` read and clear all of them.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import importlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


KERNEL_MODULES = ("s2d_conv", "fused_channelize", "viterbi", "sync_walk")
SOURCES = ("s2d_conv", "s2d_conv_tc", "s2d_conv_db", "s2d_conv_dt",
           "fused_channelize", "viterbi", "sync_walk")


def _counters() -> list:
    return [importlib.import_module(f"{__name__}.{m}").LAUNCHES
            for m in KERNEL_MODULES]


def launches() -> dict:
    """Every wrapper's launch count, by wrapper name."""
    return {k: v for counter in _counters() for k, v in counter.items()}


def reset_launches() -> None:
    for counter in _counters():
        for name in counter:
            counter[name] = 0


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a kernel source."""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    raise KernelBuildError("nvcc not found (PATH, $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin)")


@functools.lru_cache(maxsize=None)
def build(name: str) -> tuple:
    """Compile csrc/<name>.cu (once per process and version of the source
    and the csrc/*.cuh headers) and return (ctypes.CDLL, build report).
    The report holds the build time and nvcc's -Xptxas -v lines
    (registers, shared memory, spills); it is empty when an earlier
    process already built this source.  Threads may build different
    sources at once: each is its own nvcc process."""
    src = CSRC / f"{name}.cu"
    # the shared headers of csrc/ are part of every source's version
    parts = [src.read_bytes(), *(h.read_bytes()
                                 for h in sorted(CSRC.glob("*.cuh"))),
             " ".join(NVCC_FLAGS).encode()]
    digest = hashlib.sha256(b"\0".join(parts)).hexdigest()[:16]
    lib_path = BUILD_DIR / f"lib{name}_{digest}.so"
    report = ""
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        t0 = time.perf_counter()
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise KernelBuildError(
                f"nvcc failed on {src.name} (exit {proc.returncode}):\n"
                f"{proc.stderr[-4000:]}")
        os.replace(tmp, lib_path)
        report = (f"built {lib_path.name} in "
                  f"{time.perf_counter() - t0:.1f} s\n{proc.stderr}")
    return ctypes.CDLL(str(lib_path)), report
