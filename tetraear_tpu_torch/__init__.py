"""tetraear_tpu_torch — the TETRA receive framework on PyTorch and CUDA.

A port of `tetraear_tpu` (JAX/XLA/Pallas) to PyTorch, with the Pallas
kernels rewritten by hand for NVIDIA Hopper (sm_90a).  The JAX package
stays beside it as the reference; every ported stage is held against it
on the same input (tests/unit/test_torch_*.py).

Layering mirrors the reference:
  ops/          plain PyTorch DSP stages (filters, IIR, resampling, demod,
                sync, CRC, composite conv, channel coding, Viterbi)
  ops/kernels/  hand-written CUDA kernels, each beside its plain version
  models/       the single-carrier, etsi and multicarrier pipelines as
                nn.Modules, the etsi link, host decode
  core/         the host frame decoder with its sync scores on the device
  ui/           the `decode` command line
  csrc/         CUDA C++ sources, built with nvcc on first use

Host-only code (protocol parsing, TetraDecoder, IQ replay, recorders,
synthesis) is imported from the reference through `hostref`, never
copied.  Nothing here imports jax.
"""

__version__ = "0.1.0"
