"""Logging — the reference logs ``step, loss`` lines to a cfg-named log
file via Python logging (SURVEY.md §5 "Metrics / logging"); same here,
plus stderr."""

from __future__ import annotations

import logging
import os
import sys
from typing import Optional

_FMT = "%(asctime)s %(levelname)s %(name)s: %(message)s"


def get_logger(name: str = "fast_tffm_tpu_torch",
               log_file: Optional[str] = None) -> logging.Logger:
    logger = logging.getLogger(name)
    logger.propagate = False  # libraries configure the root logger too
    if not logger.handlers:
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(logging.Formatter(_FMT))
        logger.addHandler(h)
    if logger.level == logging.NOTSET:
        # Set the level even when a harness attached its own handler
        # first: NOTSET resolves through the root logger (WARNING),
        # which would silently drop every step/loss INFO line.
        logger.setLevel(logging.INFO)
    if log_file:
        have = {getattr(h, "baseFilename", None) for h in logger.handlers}
        path = os.path.abspath(log_file)
        if path not in have:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            fh = logging.FileHandler(path)
            fh.setFormatter(logging.Formatter(_FMT))
            logger.addHandler(fh)
    return logger
