"""The host frame decoder with its dense sync scores from the port.

`TetraDecoder` is the reference's `tetraear_tpu.core.decoder.TetraDecoder`
(reached through hostref, without jax) with `decode` and `find_sync`
taking their dense TS1/TS2 scores from the port's
`ops.sync.sync_correlation` on the decoder's device, where the
reference's compute them with jax.  Both then run the reference's own
`_decode_with_dense` / `find_sync(_dense=...)`.  The scores are integers
over 22 in f32 on either side, so the frames are identical.
"""

from __future__ import annotations

import numpy as np
import torch

from tetraear_tpu import constants as C
from tetraear_tpu_torch.hostref import tetra_decoder_class
from tetraear_tpu_torch.ops.sync import sync_correlation


class TetraDecoder(tetra_decoder_class()):
    """The reference decoder; the dense sync correlation runs on `device`
    (the host by default)."""

    def __init__(self, key_manager=None, auto_decrypt: bool = True, *,
                 device="cpu"):
        super().__init__(key_manager=key_manager, auto_decrypt=auto_decrypt)
        self.device = torch.device(device)

    def dense_sync(self, bits: np.ndarray) -> tuple:
        """(ts1_corr, ts2_corr) f32 at every window position."""
        b = torch.as_tensor(np.asarray(bits).astype(np.uint8),
                            device=self.device)
        corr = sync_correlation(b).cpu().numpy()
        return corr[0], corr[1]

    def find_sync(self, bits, threshold: float = 0.85,
                  return_max_corr: bool = False, _dense=None):
        bits = np.asarray(bits)
        if _dense is None:
            # short input gets an empty pair: no path of the reference's
            # find_sync then reaches its own (jax) correlation
            _dense = (self.dense_sync(bits) if len(bits) >= C.SYNC_LEN_BITS
                      else (np.zeros(0, np.float32),) * 2)
        return super().find_sync(bits, threshold, return_max_corr,
                                 _dense=_dense)

    def decode(self, symbols) -> list:
        """Symbol stream -> decoded frame dicts."""
        bits, mapped_symbols = self.symbols_to_bits(symbols)
        if bits.size < C.SYNC_LEN_BITS:
            return []
        return self._decode_with_dense(bits, mapped_symbols,
                                       self.dense_sync(bits))
