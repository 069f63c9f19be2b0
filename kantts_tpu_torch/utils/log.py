"""Logging to a run's file (counterpart of ``kantts_tpu/utils/log.py``)."""

from __future__ import annotations

import contextlib
import logging
import os
from typing import Iterator


@contextlib.contextmanager
def log_to_file(path: str) -> Iterator[None]:
    """Copy the root logger's records into ``path`` while the block runs, in
    the format of the JAX package's ``logging_to_file``."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    handler = logging.FileHandler(path)
    handler.setFormatter(logging.Formatter(
        "%(asctime)s, %(levelname)-4s [%(filename)s:%(lineno)d] %(message)s",
        datefmt="%Y-%m-%d:%H:%M:%S"))
    root = logging.getLogger()
    root.addHandler(handler)
    try:
        yield
    finally:
        root.removeHandler(handler)
        handler.close()
