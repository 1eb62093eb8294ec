"""Logging/tracing setup.

Parity target: reference core/src/tracing_config.rs + fsfs
tracing_setup.rs — library-optional structured logging configured from
FRANKENSEARCH_LOG (library never configures logging unless asked; the
product entrypoints do).
"""

from __future__ import annotations

import json
import logging
import os
import sys
import time

LOGGER_NAME = "frankensearch_tpu"


class JsonFormatter(logging.Formatter):
    """One JSON object per line (evidence-friendly)."""

    def format(self, record: logging.LogRecord) -> str:
        payload = {
            "at": time.time(),
            "level": record.levelname.lower(),
            "logger": record.name,
            "msg": record.getMessage(),
        }
        if record.exc_info:
            payload["exc"] = self.formatException(record.exc_info)
        extra = getattr(record, "fs_extra", None)
        if isinstance(extra, dict):
            payload.update(extra)
        return json.dumps(payload, default=str)


def configure_tracing(
    level: str | None = None, *, json_lines: bool | None = None, stream=None
) -> logging.Logger:
    """Configure the framework logger from FRANKENSEARCH_LOG (e.g. 'info',
    'debug', 'warning'); idempotent; never touches the root logger."""
    level_name = (level or os.environ.get("FRANKENSEARCH_LOG", "warning")).upper()
    logger = logging.getLogger(LOGGER_NAME)
    logger.setLevel(getattr(logging, level_name, logging.WARNING))
    logger.propagate = False
    if not logger.handlers:
        handler = logging.StreamHandler(stream or sys.stderr)
        use_json = (
            json_lines
            if json_lines is not None
            else os.environ.get("FRANKENSEARCH_LOG_FORMAT", "text") == "json"
        )
        if use_json:
            handler.setFormatter(JsonFormatter())
        else:
            handler.setFormatter(
                logging.Formatter("%(asctime)s %(levelname)s %(name)s %(message)s")
            )
        logger.addHandler(handler)
    return logger


def get_logger(component: str = "") -> logging.Logger:
    name = f"{LOGGER_NAME}.{component}" if component else LOGGER_NAME
    return logging.getLogger(name)
