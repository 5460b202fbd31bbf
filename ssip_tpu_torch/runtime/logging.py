"""Logging setup shared by every CLI workload of the port.

The port's own copy of ``ssip_tpu/runtime/logging.py`` (the port imports
nothing of the JAX package): one helper configures the root logger with a
stream handler, optionally teeing to a log file under ``outputs/logs/``.
"""

from __future__ import annotations

import logging
import sys
from pathlib import Path
from typing import Optional

_FORMAT = "%(asctime)s %(levelname)s %(name)s :: %(message)s"


def configure_logging(
    level: str | int = "INFO",
    log_file: Optional[Path] = None,
) -> logging.Logger:
    """Configure root logging with a stream handler and optional file tee."""
    if isinstance(level, str):
        level = getattr(logging, level.upper(), logging.INFO)

    root = logging.getLogger()
    root.setLevel(level)
    # Reset handlers so repeated CLI invocations (tests) do not stack handlers.
    for handler in list(root.handlers):
        root.removeHandler(handler)

    stream = logging.StreamHandler(sys.stderr)
    stream.setFormatter(logging.Formatter(_FORMAT))
    root.addHandler(stream)

    if log_file is not None:
        log_file = Path(log_file)
        log_file.parent.mkdir(parents=True, exist_ok=True)
        fh = logging.FileHandler(log_file, encoding="utf-8")
        fh.setFormatter(logging.Formatter(_FORMAT))
        root.addHandler(fh)

    return root


def get_logger(name: str) -> logging.Logger:
    return logging.getLogger(name)
