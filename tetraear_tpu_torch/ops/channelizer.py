"""Carrier grid of the multicarrier front end (copy of
`tetraear_tpu.ops.channelizer.carrier_grid`, whose module imports jax)."""

from __future__ import annotations

import numpy as np


def carrier_grid(num_carriers: int, spacing_hz: float = 25_000.0,
                 center_offset_hz: float = 0.0) -> np.ndarray:
    """Symmetric grid of carrier offsets around the capture center.  An
    even count lands on odd multiples of spacing/2 (±12.5 kHz, ...)."""
    idx = np.arange(num_carriers) - (num_carriers - 1) / 2.0
    return (idx * spacing_hz + center_offset_hz).astype(np.float32)
