"""GPS / location extraction from SDS text and binary LIP payloads.

Behavioral parity with tetraear/core/location.py:13-223.  Note the binary
parser here uses the reference's byte-aligned "simplified LIP" layout
(location.py:113-176), which differs from the bit-aligned ETSI layout in
protocol/lip.py — both exist in the reference and both are kept.
"""

from __future__ import annotations

import logging
import re
from typing import Optional, Tuple

logger = logging.getLogger(__name__)


class LocationParser:
    """Parse GPS and location data from TETRA messages."""

    @staticmethod
    def parse_coordinates(text: str) -> Optional[Tuple[float, float]]:
        """Lat/lon from decimal, DMS, or compact text forms."""
        if not text:
            return None

        m = re.search(r"Lat:?\s*(-?\d+\.?\d*)\s+Lon:?\s*(-?\d+\.?\d*)",
                      text, re.IGNORECASE)
        if m:
            try:
                lat, lon = float(m.group(1)), float(m.group(2))
                if -90 <= lat <= 90 and -180 <= lon <= 180:
                    return (lat, lon)
            except ValueError:
                pass

        m = re.search(r"(\d+)°(\d+)['′](\d+(?:\.\d+)?)[\"″]([NS])\s+"
                      r"(\d+)°(\d+)['′](\d+(?:\.\d+)?)[\"″]([EW])", text)
        if m:
            try:
                lat = int(m.group(1)) + int(m.group(2)) / 60 + float(m.group(3)) / 3600
                if m.group(4) == "S":
                    lat = -lat
                lon = int(m.group(5)) + int(m.group(6)) / 60 + float(m.group(7)) / 3600
                if m.group(8) == "W":
                    lon = -lon
                if -90 <= lat <= 90 and -180 <= lon <= 180:
                    return (lat, lon)
            except ValueError:
                pass

        m = re.search(r"([NS])(\d+\.?\d*)\s+([EW])(\d+\.?\d*)", text)
        if m:
            try:
                lat = float(m.group(2))
                if m.group(1) == "S":
                    lat = -lat
                lon = float(m.group(4))
                if m.group(3) == "W":
                    lon = -lon
                if -90 <= lat <= 90 and -180 <= lon <= 180:
                    return (lat, lon)
            except ValueError:
                pass
        return None

    @staticmethod
    def format_coordinates(lat: float, lon: float) -> str:
        lat_dir = "N" if lat >= 0 else "S"
        lon_dir = "E" if lon >= 0 else "W"
        return f"{abs(lat):.4f}°{lat_dir}, {abs(lon):.4f}°{lon_dir}"

    @staticmethod
    def get_google_maps_url(lat: float, lon: float) -> str:
        return f"https://www.google.com/maps?q={lat},{lon}"

    @staticmethod
    def get_openstreetmap_url(lat: float, lon: float) -> str:
        return f"https://www.openstreetmap.org/?mlat={lat}&mlon={lon}&zoom=15"

    @staticmethod
    def parse_lip_message(data: bytes) -> Optional[dict]:
        """Byte-aligned simplified LIP report (location.py:113-176)."""
        if not data or len(data) < 10:
            return None
        try:
            pdu_type = data[0]
            if pdu_type == 0x00 and len(data) >= 10:
                lat_raw = int.from_bytes(data[1:4], "big", signed=True)
                lon_raw = int.from_bytes(data[4:7], "big", signed=True)
                lat = (lat_raw / (2 ** 23)) * 180
                lon = (lon_raw / (2 ** 23)) * 180
                if -90 <= lat <= 90 and -180 <= lon <= 180:
                    return {
                        "type": "LIP Short Report",
                        "latitude": lat,
                        "longitude": lon,
                        "formatted": LocationParser.format_coordinates(lat, lon),
                    }
            elif pdu_type == 0x01 and len(data) >= 16:
                lat_raw = int.from_bytes(data[1:4], "big", signed=True)
                lon_raw = int.from_bytes(data[4:7], "big", signed=True)
                lat = (lat_raw / (2 ** 23)) * 180
                lon = (lon_raw / (2 ** 23)) * 180
                altitude = int.from_bytes(data[7:9], "big", signed=True)
                speed = int.from_bytes(data[9:11], "big")
                heading = int.from_bytes(data[11:13], "big")
                if -90 <= lat <= 90 and -180 <= lon <= 180:
                    return {
                        "type": "LIP Long Report",
                        "latitude": lat,
                        "longitude": lon,
                        "altitude": altitude,
                        "speed": speed / 10,
                        "heading": heading,
                        "formatted": LocationParser.format_coordinates(lat, lon),
                    }
        except Exception as e:
            logger.debug("Error parsing LIP: %s", e)
        return None

    @staticmethod
    def extract_location_from_frame(frame: dict) -> Optional[dict]:
        """location.py:179-223."""
        sds_msg = frame.get("sds_message", "") or frame.get("decoded_text", "")
        if "[LIP]" in sds_msg or "[LOC]" in sds_msg or "[GPS]" in sds_msg:
            coords = LocationParser.parse_coordinates(sds_msg)
            if coords:
                lat, lon = coords
                return {
                    "type": "GPS Text",
                    "latitude": lat,
                    "longitude": lon,
                    "formatted": LocationParser.format_coordinates(lat, lon),
                    "source": "SDS Message",
                }
            hex_data = sds_msg.split(":", 1)[-1].strip()
            try:
                data_bytes = bytes.fromhex(hex_data.replace(" ", ""))
                lip_data = LocationParser.parse_lip_message(data_bytes)
                if lip_data:
                    lip_data["source"] = "LIP Message"
                    return lip_data
            except Exception:
                pass
        if "mac_pdu" in frame and "data" in frame["mac_pdu"]:
            data = frame["mac_pdu"]["data"]
            if isinstance(data, (bytes, bytearray)):
                lip_data = LocationParser.parse_lip_message(data)
                if lip_data:
                    lip_data["source"] = "MAC PDU"
                    return lip_data
        return None
