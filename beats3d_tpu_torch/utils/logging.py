# Copied from beats3d_tpu/utils/logging.py (host only).
"""Structured logging (the reference has bare prints; SURVEY.md §5.5 calls for
structured logging as a first-class output)."""

from __future__ import annotations

import json
import logging
import sys
import time


def get_logger(name: str = "beats3d", level: int = logging.INFO,
               json_lines: bool = False,
               stream=None) -> logging.Logger:
    logger = logging.getLogger(name)
    if logger.handlers:
        return logger
    logger.setLevel(level)
    handler = logging.StreamHandler(stream or sys.stderr)
    if json_lines:
        handler.setFormatter(_JsonFormatter())
    else:
        handler.setFormatter(
            logging.Formatter("%(asctime)s %(name)s %(levelname)s %(message)s")
        )
    logger.addHandler(handler)
    return logger


class _JsonFormatter(logging.Formatter):
    def format(self, record):
        obj = {
            "ts": time.time(),
            "level": record.levelname,
            "logger": record.name,
            "msg": record.getMessage(),
        }
        if hasattr(record, "metrics"):
            obj["metrics"] = record.metrics
        return json.dumps(obj)
