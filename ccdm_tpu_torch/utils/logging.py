"""Colored console logging (a copy of `ccdm_tpu/utils/logging.py`; parity:
ignite `setup_logger` use, `trainer.py:685`)."""

from __future__ import annotations

import logging
import sys


def setup_logger(level: int = logging.INFO) -> logging.Logger:
    root = logging.getLogger()
    root.setLevel(level)
    if not any(isinstance(h, logging.StreamHandler) for h in root.handlers):
        handler = logging.StreamHandler(sys.stdout)
        handler.setFormatter(logging.Formatter(
            "\x1b[32;1m%(asctime)s [%(name)s]\x1b[0m %(message)s"))
        root.addHandler(handler)
    return root
