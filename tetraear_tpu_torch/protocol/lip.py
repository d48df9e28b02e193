"""LIP (Location Information Protocol, ETSI TS 100 392-18-1) parsing.

Behavioral parity with tetraear/core/protocol.py:1020-1088: short/long
basic location reports with the reference's bit-field scaling, plus the NMEA
passthrough heuristic.
"""

from __future__ import annotations

import logging
from typing import Optional

from tetraear_tpu_torch.protocol.bits import bytes_to_bits, bits_to_uint, bits_to_int

logger = logging.getLogger(__name__)


def parse_lip(data: bytes) -> Optional[str]:
    if not data or len(data) < 2:
        return None
    try:
        bits = bytes_to_bits(data)
        pdu_type = bits_to_uint(bits[0:2])

        if pdu_type == 0:  # Short Location Report
            if len(bits) < 65:
                return None
            lat_raw = bits_to_int(bits[4:28])       # 24-bit two's complement
            latitude = lat_raw * 90.0 / (1 << 23)
            lon_raw = bits_to_int(bits[28:53])      # 25-bit two's complement
            longitude = lon_raw * 180.0 / (1 << 24)
            return f"Lat: {latitude:.5f}, Lon: {longitude:.5f} (Short)"

        if pdu_type == 1:  # Long Location Report
            if len(bits) < 75:
                return None
            lat_raw = bits_to_int(bits[4:29])       # 25 bits
            latitude = lat_raw * 90.0 / (1 << 24)
            lon_raw = bits_to_int(bits[29:55])      # 26 bits
            longitude = lon_raw * 180.0 / (1 << 25)
            return f"Lat: {latitude:.5f}, Lon: {longitude:.5f} (Long)"

        try:
            text = data.decode("ascii")
            if "$GPGGA" in text or "$GPRMC" in text:
                return f"NMEA: {text.strip()}"
        except Exception:
            pass
    except Exception as e:
        logger.debug("LIP parsing error: %s", e)
    return None
