"""Structured logging setup.

The reference configures per-process file+stdout loggers ad hoc
(infrenceServer.py:22-30, trainingServer.py:40-48, peopleCount.py:21-29).
Here one helper does it, and loggers default to stdout-only so tests and
containers stay clean; pass ``logfile=`` for the reference's file behavior.
"""

from __future__ import annotations

import logging
import sys

_FMT = "%(asctime)s %(levelname)s %(name)s: %(message)s"


def setup_logging(name: str = "fre", level: int = logging.INFO, logfile: str | None = None) -> logging.Logger:
    logger = logging.getLogger(name)
    if logger.handlers:
        return logger
    logger.setLevel(level)
    sh = logging.StreamHandler(sys.stdout)
    sh.setFormatter(logging.Formatter(_FMT))
    logger.addHandler(sh)
    if logfile:
        fh = logging.FileHandler(logfile)
        fh.setFormatter(logging.Formatter(_FMT))
        logger.addHandler(fh)
    logger.propagate = False
    return logger
