"""tetraear_tpu_torch — the TETRA receive framework on PyTorch and CUDA.

A port of `tetraear_tpu` (JAX/XLA/Pallas) to PyTorch, with the Pallas
kernels rewritten by hand for NVIDIA Hopper (sm_90a).  The JAX package
stays beside it as the reference; every ported stage is held against it
on the same input (tests/unit/test_torch_*.py).

Layering mirrors the reference (host modules are the port's own copies
of the reference's, at the same paths):
  ops/          plain PyTorch DSP stages (filters, IIR, resampling, demod,
                sync, CRC, composite conv, channel coding, Viterbi)
  ops/kernels/  hand-written CUDA kernels, each beside its plain version
  models/       the single-carrier, etsi and multicarrier pipelines as
                nn.Modules, the etsi link, host decode
  core/         the host frame decoder with its sync scores on the device
  protocol/     MAC / SDS / LIP parsing
  crypto/       TEA1-4 and key handling (native engine from native/)
  io/           IQ file replay and frame recorders
  utils/        IQ synthesis, the native host-DSP engine
  constants.py, config.py
  ui/           the `decode` command line
  csrc/         CUDA C++ sources, built with nvcc on first use

The port keeps its own copy of every host module it needs: nothing here
imports jax or the JAX package `tetraear_tpu`, not even its modules that
do not import jax (tests/unit/test_torch_hostcode.py holds it to that).
"""

__version__ = "0.1.0"
