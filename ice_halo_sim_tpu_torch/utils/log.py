"""Named loggers + callback sink.

Mirrors the reference's logging utility (reference/src/util/logger.hpp:
spdlog behind named loggers, a GUI callback sink via callback_sink.hpp, and
the C API's LUMICE_SetLogLevel / SetLogCallback) on top of the stdlib
``logging`` module. All package logging goes through ``get_logger`` so a
single call controls levels and front-ends can attach a callback sink.
"""

from __future__ import annotations

import logging
from typing import Callable, Optional

_ROOT_NAME = "iht"
_callback_handler: Optional[logging.Handler] = None

LEVELS = {
    "trace": logging.DEBUG,  # stdlib has no TRACE; map to DEBUG
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warn": logging.WARNING,
    "warning": logging.WARNING,
    "error": logging.ERROR,
    "critical": logging.CRITICAL,
    "off": logging.CRITICAL + 10,
}


def get_logger(name: str = "") -> logging.Logger:
    """Named logger under the package root ('iht', 'iht.engine', ...)."""
    full = _ROOT_NAME if not name else f"{_ROOT_NAME}.{name}"
    logger = logging.getLogger(full)
    root = logging.getLogger(_ROOT_NAME)
    if not root.handlers:
        h = logging.StreamHandler()
        h.setFormatter(
            logging.Formatter("[%(asctime)s] [%(name)s] [%(levelname)s] %(message)s",
                              datefmt="%H:%M:%S")
        )
        root.addHandler(h)
        root.setLevel(logging.WARNING)
    return logger


def set_log_level(level: str) -> None:
    """Set the package-wide level by name (LUMICE_SetLogLevel semantics)."""
    if level.lower() not in LEVELS:
        raise ValueError(f"unknown log level {level!r}")
    get_logger().setLevel(LEVELS[level.lower()])


class _CallbackHandler(logging.Handler):
    def __init__(self, fn: Callable[[str, str, str], None]):
        super().__init__()
        self._fn = fn

    def emit(self, record: logging.LogRecord) -> None:
        try:
            self._fn(record.levelname.lower(), record.name, record.getMessage())
        except Exception:  # callback errors must never break the pipeline
            pass


def set_log_callback(fn: Optional[Callable[[str, str, str], None]]) -> None:
    """Attach/detach a (level, logger_name, message) sink — the callback
    sink the reference offers GUIs (LUMICE_SetLogCallback)."""
    global _callback_handler
    root = get_logger()
    if _callback_handler is not None:
        root.removeHandler(_callback_handler)
        _callback_handler = None
    if fn is not None:
        _callback_handler = _CallbackHandler(fn)
        root.addHandler(_callback_handler)
