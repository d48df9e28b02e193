"""Settings and frequency presets (behavioral parity with
tetraear/ui/modern.py:326-413)."""

from __future__ import annotations

import json
import logging
import os

from tetraear_tpu_torch.ui.logging_setup import get_user_data_dir

logger = logging.getLogger(__name__)


class SettingsManager:
    """settings.json in the user data dir."""

    DEFAULT_SETTINGS = {
        "save_silence": False,
        "export_mp3": False,
        "auto_decrypt": True,
        "monitor_audio": False,
        "monitor_raw": False,
        "gain": 50.0,
        "sample_rate": 2.4e6,
        "last_frequency": 390.865,
        "bandwidth": 25000,
        "zoom_level": 1.0,
        "noise_floor": -85,
        "theme": "dark",
    }

    def __init__(self, filename: str = "settings.json"):
        data_dir = get_user_data_dir()
        data_dir.mkdir(parents=True, exist_ok=True)
        self.filename = str(data_dir / filename)
        self.settings = self.DEFAULT_SETTINGS.copy()
        self.load()

    def load(self) -> None:
        try:
            if os.path.exists(self.filename):
                with open(self.filename, "r") as f:
                    self.settings.update(json.load(f))
        except Exception as e:
            logger.error("Failed to load settings: %s", e)

    def save(self) -> None:
        try:
            with open(self.filename, "w") as f:
                json.dump(self.settings, f, indent=4)
        except Exception as e:
            logger.error("Failed to save settings: %s", e)

    def get(self, key, default=None):
        return self.settings.get(key, default)

    def set(self, key, value):
        self.settings[key] = value


class FrequencyManager:
    """frequencies.json presets."""

    DEFAULT_FREQUENCIES = [
        {"freq": 390.000, "label": "TETRA PL 1", "desc": "Poland Public Safety"},
        {"freq": 392.500, "label": "TETRA PL 2", "desc": "Poland Public Safety"},
        {"freq": 420.000, "label": "TETRA EU", "desc": "Europe General"},
    ]

    def __init__(self, filename: str = "frequencies.json"):
        data_dir = get_user_data_dir()
        data_dir.mkdir(parents=True, exist_ok=True)
        self.filename = str(data_dir / filename)
        self.frequencies = []
        self.load()

    def load(self) -> None:
        try:
            if os.path.exists(self.filename):
                with open(self.filename, "r") as f:
                    self.frequencies = json.load(f)
            else:
                self.frequencies = [dict(d) for d in self.DEFAULT_FREQUENCIES]
        except Exception as e:
            logger.error("Failed to load frequencies: %s", e)

    def save(self) -> None:
        try:
            with open(self.filename, "w") as f:
                json.dump(self.frequencies, f, indent=4)
        except Exception as e:
            logger.error("Failed to save frequencies: %s", e)

    def add(self, freq, label, desc=""):
        self.frequencies.append({"freq": freq, "label": label, "desc": desc})
        self.save()

    def get_all(self):
        return self.frequencies
