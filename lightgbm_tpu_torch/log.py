"""Logging of the port: ``[LightGBM-TPU] [Info]`` lines on stdout, the
JAX package's ``utils/log.py`` format, so a training run prints the same
text through either package.

``verbosity`` (the parameter) applies for the duration of one ``train``
or ``cv`` call (:func:`scoped_verbosity`): below 1 it silences them.
:func:`register_logger` routes the lines to another
``logging.Logger``.
"""

from __future__ import annotations

import logging
import sys
from contextlib import contextmanager
from typing import Optional

__all__ = ["log_info", "register_logger", "scoped_verbosity"]

_logger: Optional[logging.Logger] = None
_verbosity = 1


def _default_logger() -> logging.Logger:
    logger = logging.getLogger("lightgbm_tpu_torch")
    if not logger.handlers:
        h = logging.StreamHandler(sys.stdout)
        h.setFormatter(logging.Formatter("%(message)s"))
        logger.addHandler(h)
        logger.setLevel(logging.INFO)
    return logger


def register_logger(logger: Optional[logging.Logger]) -> None:
    """Send the lines to ``logger`` (None: back to stdout)."""
    global _logger
    _logger = logger


@contextmanager
def scoped_verbosity(v: int):
    global _verbosity
    prev, _verbosity = _verbosity, v
    try:
        yield
    finally:
        _verbosity = prev


def log_info(msg: str) -> None:
    if _verbosity >= 1:
        (_logger or _default_logger()).info(f"[LightGBM-TPU] [Info] {msg}")

