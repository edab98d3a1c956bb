"""Structured logging for the launchers.

``launch/train.py``/``launch/serve.py`` used bare ``print()``; this
wraps stdlib :mod:`logging` with a formatter that keeps the default
human-readable output byte-stable (message only, no timestamp prefix,
so examples and docs keep matching) while gaining ``--log-level``
filtering and ``key=value`` structured fields::

    log = get_logger("train")
    log.info("step %(step)5d loss=%(loss).4f", step=10, loss=1.2)
    log.info("recovered at step %d", 42)          # printf style works too

Fields passed as keywords format through ``%(name)s`` placeholders in
the message; at DEBUG the raw field dict is appended for grepping.
"""
from __future__ import annotations

import logging
import sys
from typing import Any

__all__ = ["configure", "get_logger"]

_ROOT = "repro_torch"
_configured = False


class _KVLogger(logging.LoggerAdapter):
    """Adapter accepting structured fields as keyword arguments."""

    def log_kv(self, level: int, msg: str, *args, **fields) -> None:
        if not self.isEnabledFor(level):
            return
        if fields:
            try:
                msg = msg % fields
            except (KeyError, TypeError, ValueError):
                msg = f"{msg} {fields}"
        self.logger.log(level, msg, *args)

    def info(self, msg, *args, **fields):
        self.log_kv(logging.INFO, msg, *args, **fields)

    def debug(self, msg, *args, **fields):
        self.log_kv(logging.DEBUG, msg, *args, **fields)

    def warning(self, msg, *args, **fields):
        self.log_kv(logging.WARNING, msg, *args, **fields)

    def error(self, msg, *args, **fields):
        self.log_kv(logging.ERROR, msg, *args, **fields)


def configure(level: str = "info", stream=None) -> None:
    """Idempotent root setup: message-only format to stdout (matching
    the old ``print()`` output), level from ``--log-level``."""
    global _configured
    root = logging.getLogger(_ROOT)
    root.setLevel(getattr(logging, level.upper(), logging.INFO))
    if not _configured:
        handler = logging.StreamHandler(stream or sys.stdout)
        handler.setFormatter(logging.Formatter("%(message)s"))
        root.addHandler(handler)
        root.propagate = False
        _configured = True


def get_logger(name: str = "") -> _KVLogger:
    configure()
    full = f"{_ROOT}.{name}" if name else _ROOT
    return _KVLogger(logging.getLogger(full), {})


def set_level(level: str) -> None:
    logging.getLogger(_ROOT).setLevel(
        getattr(logging, level.upper(), logging.INFO))


def kv(**fields: Any) -> str:
    """Render fields as a stable ``k=v`` suffix for step lines."""
    return " ".join(f"{k}={v}" for k, v in fields.items())
