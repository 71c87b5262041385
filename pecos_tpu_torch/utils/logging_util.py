"""Logging set-up for the CLIs, with verbosity levels 0-3 (counterpart of
``pecos_tpu/utils/logging_util.py``)."""

from __future__ import annotations

import logging
import sys

LOGGING_LEVELS = {0: logging.ERROR, 1: logging.WARNING, 2: logging.INFO, 3: logging.DEBUG}


def setup_logging_config(level: int = 1):
    """Configure root logging to stdout; ``level`` is a verbosity 0-3 (higher
    values mean DEBUG), not a ``logging`` level."""
    logging.basicConfig(
        level=LOGGING_LEVELS.get(level, logging.DEBUG),
        stream=sys.stdout,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
        force=True,
    )
