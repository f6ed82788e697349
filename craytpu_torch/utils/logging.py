"""Leveled logger with ANSI colors and fatal-on-error semantics.

Equivalent of the reference logger (utils/logging.c:50-74): INFO/WARN/ERR/DEBG
plus plain output, timestamps, `debug` gated on verbose mode, and `error`
terminating the process. Also provides the `smart_time` humanizer
(utils/logging.c:84-101).
"""

from __future__ import annotations

import os
import sys
import time

_VERBOSE = False


def set_verbose(v: bool) -> None:
    global _VERBOSE
    _VERBOSE = bool(v)


def is_verbose() -> bool:
    return _VERBOSE


def _use_color(stream) -> bool:
    if os.environ.get("NO_COLOR"):
        return False
    return hasattr(stream, "isatty") and stream.isatty()


_COLORS = {
    "info": "\033[34m",   # blue
    "warning": "\033[33m",  # yellow
    "error": "\033[31m",  # red
    "debug": "\033[90m",  # gray
}
_RESET = "\033[0m"


def _emit(level: str, msg: str, stream=None) -> None:
    stream = stream or (sys.stderr if level in ("warning", "error") else sys.stdout)
    ts = time.strftime("%Y-%m-%d %H:%M:%S")
    tag = {"info": "INFO", "warning": "WARN", "error": "ERR ", "debug": "DEBG"}[level]
    if _use_color(stream):
        tag = f"{_COLORS[level]}{tag}{_RESET}"
    stream.write(f"[{ts}] [{tag}] {msg}\n")
    stream.flush()


def info(msg: str, *args) -> None:
    _emit("info", msg % args if args else msg)


def warning(msg: str, *args) -> None:
    _emit("warning", msg % args if args else msg)


def debug(msg: str, *args) -> None:
    if _VERBOSE:
        _emit("debug", msg % args if args else msg)


def plain(msg: str, *args) -> None:
    sys.stdout.write(msg % args if args else msg)
    sys.stdout.flush()


class FatalError(SystemExit):
    """Raised by error(); terminates the process like logr(error,...) does."""


def error(msg: str, *args) -> None:
    _emit("error", msg % args if args else msg)
    raise FatalError(1)


def smart_time(ms: float) -> str:
    """Humanize a millisecond duration (utils/logging.c:84-101)."""
    if ms < 1000:
        return f"{ms:.0f}ms"
    s = ms / 1000.0
    if s < 60:
        return f"{s:.2f}s"
    m = s / 60.0
    if m < 60:
        return f"{m:.2f}m"
    h = m / 60.0
    return f"{h:.2f}h"
