"""Colour console logger and scalar metrics writer.

Counterpart of mofa_tpu/utils/logging.py (the reference's colorlog logger,
MOFA-Video-Traj/utils/utils.py:32-60, and accelerate's scalar reporting,
train_stage1.py:660-664,1174), with the standard library only:

- `get_logger(name)`: a logger writing "HH:MM:SS LEVEL name: message" to
  stderr, each line in its level's ANSI colour when stderr is a terminal;
- `MetricsWriter(directory)`: an append-only JSONL file, one
  {"step", "time", scalars...} object a line, flushed at every write.
"""

from __future__ import annotations

import json
import logging
import os
import sys
import time

_COLORS = {"DEBUG": "\033[36m", "INFO": "\033[32m", "WARNING": "\033[33m",
           "ERROR": "\033[31m", "CRITICAL": "\033[35m"}
_RESET = "\033[0m"
FORMAT = "%(asctime)s %(levelname)s %(name)s: %(message)s"
DATE_FORMAT = "%H:%M:%S"


class _ColorFormatter(logging.Formatter):
    def format(self, record):
        msg = super().format(record)
        if sys.stderr.isatty():
            return f"{_COLORS.get(record.levelname, '')}{msg}{_RESET}"
        return msg


def get_logger(name: str = "mofa_tpu_torch", level: int = logging.INFO) -> logging.Logger:
    """The named logger, given one colour handler on stderr the first time
    (later calls return it as it is); it does not propagate to the root."""
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(_ColorFormatter(FORMAT, DATE_FORMAT))
        logger.addHandler(handler)
        logger.setLevel(level)
        logger.propagate = False
    return logger


class MetricsWriter:
    """Append-only JSONL scalar log (one line per step)."""

    def __init__(self, directory: str, filename: str = "metrics.jsonl"):
        os.makedirs(directory, exist_ok=True)
        self.path = os.path.join(directory, filename)
        self._fh = open(self.path, "a")

    def write(self, step: int, **scalars):
        rec = {"step": step, "time": time.time()}
        rec.update({k: float(v) for k, v in scalars.items()})
        self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()

    def close(self):
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
