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
  csrc/         their CUDA C++ sources, built with nvcc on first use
  models/       the single-carrier, etsi, multicarrier, downlink and
                uplink pipelines as nn.Modules, the etsi link
  parallel/     the (carrier, time) mesh on torch.distributed, overlap-
                save halos, the sharded receive steps
  core/         the host frame decoder (its sync scores on the device),
                validation, locations, calls
  protocol/     MAC / SDS / LIP / layer-3 parsing
  crypto/       TEA1-4 and key handling (native engine from native/)
  signal/       the signal detector and the frequency scanner
  audio/        the ETSI ACELP codec's subprocesses, voice plumbing
  io/           IQ file replay, SDR capture, frame recorders and queries
  ui/           the command line (decode, downlink, uplink, listen, tui,
                scan, waterfall, frames, codec, devices), the receive
                loop, logging and settings
  utils/        IQ synthesis, metrics, the native host-DSP engine
  tools/        twins of the repo's tools/*.py (python -m
                tetraear_tpu_torch.tools.<name>)
  entry.py      a forward step, the rank launcher, a multi-rank dry run
  constants.py, config.py

The facade below is the reference's: `ReceiverConfig`, `DecoderConfig`
and `DEFAULT_CONFIG`, and eleven classes loaded on first use, so that
importing the package builds and launches nothing.  The device rule
holds for them: a class that puts tensors on a device takes it as the
keyword-only `device` (e.g. `TetraDecoder(device="cuda")`,
`SignalProcessor(device="cuda")`) and never picks one itself.

The port keeps its own copy of every host module it needs: nothing here
imports jax or the JAX package `tetraear_tpu`, not even its modules that
do not import jax (tests/unit/test_torch_hostcode.py holds it to that).
"""

__version__ = "0.1.0"

from tetraear_tpu_torch.config import (  # noqa: F401
    DEFAULT_CONFIG, DecoderConfig, ReceiverConfig)

_LAZY = {
    "SignalProcessor": "tetraear_tpu_torch.models.receiver",
    "TetraDecoder": "tetraear_tpu_torch.core.decoder",
    "TetraProtocolParser": "tetraear_tpu_torch.protocol.parser",
    "TEADecryptor": "tetraear_tpu_torch.crypto.tea",
    "TetraKeyManager": "tetraear_tpu_torch.crypto.keys",
    "TetraSignalValidator": "tetraear_tpu_torch.core.validator",
    "VoiceProcessor": "tetraear_tpu_torch.audio.voice",
    "TetraSignalDetector": "tetraear_tpu_torch.signal.detector",
    "FrequencyScanner": "tetraear_tpu_torch.signal.scanner",
    "BladeRFCapture": "tetraear_tpu_torch.io.capture",
    "FileReplaySource": "tetraear_tpu_torch.io.replay",
}

# the reference's facade exports, as the JAX package lists them
__all__ = ["TetraDecoder", "TEADecryptor", "TetraKeyManager",
           "TetraProtocolParser", "SignalProcessor", "BladeRFCapture",
           "TetraSignalDetector", "VoiceProcessor", "FrequencyScanner",
           "TetraSignalValidator", "FileReplaySource", "ReceiverConfig",
           "DecoderConfig"]


def __getattr__(name):
    """The eleven classes, imported from their modules on first use."""
    if name in _LAZY:
        import importlib
        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(
        f"module 'tetraear_tpu_torch' has no attribute {name!r}")
