"""Per-run multi-file logging (port of `tetraear_tpu.ui.logging_setup`,
behavioral parity with tetraear/ui/modern.py:69-175).

Six log files routed by logger-name prefix filters:
  tetraear_tpu_<run>.log  everything
  app_<run>.log           UI + capture/signal pipeline
  decoder_<run>.log       decoder/protocol
  codec_<run>.log         codec subprocess calls + stdout/stderr
  audio_<run>.log         recording + audio pipeline
  frames_<run>.log        decoded frames as JSONL

The files, directories and environment overrides are the reference's;
the prefix filters name this package's modules, which route as the
reference's own do.  The reference's quieting of jax's loggers stays as
a list of logger names: the port imports no jax, but a process that
holds both packages (the tests) keeps jax's DEBUG chatter off the
console.
"""

from __future__ import annotations

import logging
import os
import sys
from datetime import datetime
from pathlib import Path
from typing import Dict, Optional

_RUN_ID = datetime.now().strftime("%Y%m%d_%H%M%S")
_PKG = "tetraear_tpu_torch"

_ANSI = {
    "DEBUG": "\x1b[36m", "INFO": "\x1b[32m", "WARNING": "\x1b[33m",
    "ERROR": "\x1b[31m", "CRITICAL": "\x1b[1;41;37m",
}
_RESET = "\x1b[0m"


def get_user_data_dir() -> Path:
    override = os.environ.get("TETRAEAR_TPU_DATA_DIR") \
        or os.environ.get("TETRAEAR_DATA_DIR")
    if override:
        return Path(override)
    base = os.environ.get("APPDATA") or os.environ.get("LOCALAPPDATA")
    if base:
        return Path(base) / "TetraEarTPU"
    return Path.home() / ".tetraear_tpu"


def get_records_dir() -> Path:
    override = os.environ.get("TETRAEAR_TPU_RECORDS_DIR") \
        or os.environ.get("TETRAEAR_RECORDS_DIR")
    if override:
        return Path(override)
    return Path.cwd() / "records"


def get_log_dir() -> Path:
    override = os.environ.get("TETRAEAR_TPU_LOG_DIR") \
        or os.environ.get("TETRAEAR_LOG_DIR")
    if override:
        return Path(override)
    return Path.cwd() / "logs"


class ColoredFormatter(logging.Formatter):
    def format(self, record):
        if hasattr(sys.stdout, "isatty") and sys.stdout.isatty():
            color = _ANSI.get(record.levelname)
            if color:
                record.levelname = f"{color}{record.levelname}{_RESET}"
        return super().format(record)


class PrefixFilter(logging.Filter):
    def __init__(self, *prefixes: str):
        super().__init__()
        self._prefixes = tuple(p for p in prefixes if p)

    def filter(self, record: logging.LogRecord) -> bool:
        return record.name.startswith(self._prefixes) if self._prefixes else True


def setup_logging(verbose: bool = False,
                  log_dir: Optional[Path] = None) -> Dict[str, Path]:
    log_dir = Path(log_dir) if log_dir else get_log_dir()
    log_dir.mkdir(parents=True, exist_ok=True)

    files = {
        "all": log_dir / f"tetraear_tpu_{_RUN_ID}.log",
        "app": log_dir / f"app_{_RUN_ID}.log",
        "decoder": log_dir / f"decoder_{_RUN_ID}.log",
        "codec": log_dir / f"codec_{_RUN_ID}.log",
        "audio": log_dir / f"audio_{_RUN_ID}.log",
        "frames": log_dir / f"frames_{_RUN_ID}.log",
    }

    fmt = logging.Formatter(
        "%(asctime)s.%(msecs)03d [%(levelname)s] %(name)s: %(message)s",
        "%Y-%m-%d %H:%M:%S")

    def file_handler(path: Path, level=logging.DEBUG, filt=None):
        h = logging.FileHandler(str(path), encoding="utf-8", delay=True)
        h.setLevel(level)
        h.setFormatter(fmt)
        if filt is not None:
            h.addFilter(filt)
        return h

    root = logging.getLogger()
    root.setLevel(logging.DEBUG)
    root.handlers.clear()
    root.addHandler(file_handler(files["all"]))
    root.addHandler(file_handler(
        files["app"], filt=PrefixFilter(f"{_PKG}.ui", f"{_PKG}.signal",
                                        f"{_PKG}.io", f"{_PKG}.models")))
    root.addHandler(file_handler(
        files["decoder"], filt=PrefixFilter(f"{_PKG}.core", f"{_PKG}.protocol",
                                            f"{_PKG}.crypto")))
    root.addHandler(file_handler(
        files["codec"], filt=PrefixFilter(f"{_PKG}.codec")))
    root.addHandler(file_handler(
        files["audio"], filt=PrefixFilter(f"{_PKG}.recording",
                                          f"{_PKG}.audio")))
    root.addHandler(file_handler(
        files["frames"], level=logging.INFO,
        filt=PrefixFilter(f"{_PKG}.frames")))

    console = logging.StreamHandler(sys.stdout)
    console.setLevel(logging.DEBUG if verbose else logging.INFO)
    console.setFormatter(ColoredFormatter(
        "%(asctime)s [%(levelname)s] %(name)s: %(message)s"))
    root.addHandler(console)

    logging.captureWarnings(True)
    for noisy in ("jax", "jax._src", "absl"):
        logging.getLogger(noisy).setLevel(logging.WARNING)
    return files
