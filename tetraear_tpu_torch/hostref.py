"""The reference package's host-only modules, reached without jax.

The port imports the reference's host code — TetraDecoder, the protocol
parser, the frame synthesizer — instead of copying it.  Those modules
take their numpy CRC oracles (`soft_crc_check_host`, `crc16_bits_arr`,
`_crc_matrix`) from `tetraear_tpu.ops.crc`, a module that imports jax at
its top for its device functions.  `_serve_host_crc` registers a module
holding exactly those oracles, from `tetraear_tpu_torch.ops.crc`, under
that name before the host code is first imported, so the host decoder
runs on a machine without jax.  Where the JAX package's module is loaded
already, it stays in place; where a JAX-package module later asks the
stand-in for a device function, the stand-in loads the real module in
its own place and hands that over.
"""

from __future__ import annotations

import importlib
import sys
import types

_CRC_MODULE = "tetraear_tpu.ops.crc"
_HOST_CRC_NAMES = ("crc16_bits", "crc16_bits_arr", "_crc_matrix",
                   "soft_crc_check_host")


def _serve_host_crc() -> None:
    if _CRC_MODULE in sys.modules:
        return
    import tetraear_tpu.ops  # noqa: F401  (the parent package; no jax)
    from tetraear_tpu_torch.ops import crc
    stand_in = types.ModuleType(
        _CRC_MODULE, "Host CRC oracles of tetraear_tpu_torch.ops.crc, "
        "standing in for the JAX package's module.")
    for name in _HOST_CRC_NAMES:
        setattr(stand_in, name, getattr(crc, name))

    def __getattr__(name):
        if name.startswith("__"):
            raise AttributeError(name)
        if sys.modules.get(_CRC_MODULE) is stand_in:
            del sys.modules[_CRC_MODULE]
        return getattr(importlib.import_module(_CRC_MODULE), name)

    stand_in.__getattr__ = __getattr__
    sys.modules[_CRC_MODULE] = stand_in


def tetra_decoder_class():
    """tetraear_tpu.core.decoder.TetraDecoder (host MAC/SDS decode).  Only
    `decode_frontend` is jax-free; `decode` and `find_sync` reach the
    reference's device correlation, which the port's subclass
    (`tetraear_tpu_torch.core.decoder.TetraDecoder`) replaces."""
    _serve_host_crc()
    from tetraear_tpu.core.decoder import TetraDecoder
    return TetraDecoder


def protocol_parser_class():
    """tetraear_tpu.protocol.parser.TetraProtocolParser (host MAC parse)."""
    _serve_host_crc()
    from tetraear_tpu.protocol.parser import TetraProtocolParser
    return TetraProtocolParser


def synth():
    """tetraear_tpu.utils.synth (numpy TETRA burst synthesis)."""
    _serve_host_crc()
    from tetraear_tpu.utils import synth as module
    return module
