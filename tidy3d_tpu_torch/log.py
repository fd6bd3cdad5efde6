"""Logging for tidy3d_tpu — console/file handlers, log-once suppression,
consolidated warning capture for validators.

Behavioral model: /root/reference/tidy3d/log.py (custom Logger with handler
dict, capture contexts) — re-implemented minimally without external deps
beyond `rich` (which is available).
"""

from __future__ import annotations

import sys
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

# level names -> numeric values (matches python logging scale, plus backend levels)
LogLevelValues = {
    "DEBUG": 10,
    "SUPPORT": 12,
    "USER": 15,
    "INFO": 20,
    "WARNING": 30,
    "ERROR": 40,
    "CRITICAL": 50,
    "NONE": 100,
}

LogValue = Union[int, str]

DEFAULT_LEVEL = "WARNING"

_level_print_name = {
    "WARNING": "WARNING",
    "ERROR": "ERROR",
    "CRITICAL": "CRITICAL",
    "INFO": "INFO",
    "DEBUG": "DEBUG",
    "SUPPORT": "SUPPORT",
    "USER": "USER",
}


def _get_level_int(level: LogValue) -> int:
    """Convert a level name or int to an int."""
    if isinstance(level, int):
        return level
    level = str(level).upper()
    if level not in LogLevelValues:
        raise ValueError(f"Unknown log level '{level}'")
    return LogLevelValues[level]


class LogHandler:
    """Handle log messages with a given level threshold, writing to a stream."""

    def __init__(self, console, level: LogValue):
        self.level = _get_level_int(level)
        self.console = console

    def handle(self, level: int, level_name: str, message: str) -> None:
        if level >= self.level:
            stream = self.console if self.console is not None else sys.stderr
            print(f"{level_name:<9} {message}", file=stream)


class Logger:
    """Custom logger with multiple handlers, warning capture, and log-once."""

    def __init__(self):
        self.handlers: Dict[str, LogHandler] = {}
        self._capture: bool = False
        self.captured_warnings: List[Dict[str, Any]] = []
        self._logged_once: set = set()
        self.suppression: bool = True
        # stack of warning-capture contexts (mirrors reference consolidation)
        self._stack: Optional[list] = None

    # --- capture machinery (used by validators to consolidate warnings) -----
    def set_capture(self, capture: bool) -> None:
        self._capture = capture

    def begin_capture(self) -> None:
        self._capture = True
        self.captured_warnings = []

    def end_capture(self, *args) -> List[Dict[str, Any]]:
        self._capture = False
        captured = self.captured_warnings
        self.captured_warnings = []
        return captured

    # --- emission -----------------------------------------------------------
    def _log(self, level: int, level_name: str, message: str, *args,
             log_once: bool = False, custom_loc: Any = None) -> None:
        if args:
            try:
                message = str(message) % args
            except TypeError:
                message = str(message)
        else:
            message = str(message)

        if log_once and self.suppression:
            key = (level, message)
            if key in self._logged_once:
                return
            self._logged_once.add(key)

        if level >= LogLevelValues["WARNING"] and self._capture:
            self.captured_warnings.append({"level": level_name, "message": message, "loc": custom_loc})

        for handler in self.handlers.values():
            handler.handle(level, level_name, message)

    def log(self, level: LogValue, message: str, *args, log_once: bool = False) -> None:
        level_int = _get_level_int(level)
        name = level if isinstance(level, str) else str(level)
        self._log(level_int, name, message, *args, log_once=log_once)

    def debug(self, message: str, *args, **kwargs) -> None:
        self._log(10, "DEBUG", message, *args, **kwargs)

    def support(self, message: str, *args, **kwargs) -> None:
        self._log(12, "SUPPORT", message, *args, **kwargs)

    def user(self, message: str, *args, **kwargs) -> None:
        self._log(15, "USER", message, *args, **kwargs)

    def info(self, message: str, *args, **kwargs) -> None:
        self._log(20, "INFO", message, *args, **kwargs)

    def warning(self, message: str, *args, log_once: bool = False, custom_loc: Any = None) -> None:
        self._log(30, "WARNING", message, *args, log_once=log_once, custom_loc=custom_loc)

    def error(self, message: str, *args, **kwargs) -> None:
        self._log(40, "ERROR", message, *args, **kwargs)

    def critical(self, message: str, *args, **kwargs) -> None:
        self._log(50, "CRITICAL", message, *args, **kwargs)

    # --- consolidated capture context (reference: log.py:93+) ---------------
    def consolidated_warning(self, *args, **kwargs):
        return self


log = Logger()


def set_logging_level(level: LogValue = DEFAULT_LEVEL) -> None:
    """Set the console logging level."""
    if "console" in log.handlers:
        log.handlers["console"].level = _get_level_int(level)


def set_logging_console(stderr: bool = False) -> None:
    """Add a console handler."""
    stream = sys.stderr if stderr else sys.stdout
    log.handlers["console"] = LogHandler(stream, DEFAULT_LEVEL)


def set_logging_file(fname: str, filemode: str = "w", level: LogValue = DEFAULT_LEVEL) -> None:
    """Add a file handler writing to ``fname``."""
    try:
        fobj = open(fname, filemode)
    except OSError as exc:
        log.error(f"Failed to open log file '{fname}': {exc}")
        return
    log.handlers["file"] = LogHandler(fobj, level)


# initialize console on import (mirrors reference default behavior)
set_logging_console()
