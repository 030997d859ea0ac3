"""Structured logging — levels + key=value context, unlike the reference's
~40 bare Console.WriteLine call sites (SURVEY.md §5).

Built on stdlib logging so applications can reroute handlers; `get_logger`
returns a namespaced logger with a compact formatter, and `kv()` renders
structured fields consistently:

    log = slog.get_logger("net")
    log.info("client joined %s", slog.kv(id=3, endpoint=ep))
"""

from __future__ import annotations

import logging
import os
import sys

_FORMAT = "%(asctime)s %(levelname).1s %(name)s: %(message)s"
_configured = False


def _configure() -> None:
    global _configured
    if _configured:
        return
    root = logging.getLogger("srt")
    if not root.handlers:
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(logging.Formatter(_FORMAT, datefmt="%H:%M:%S"))
        root.addHandler(h)
    root.setLevel(os.environ.get("SRT_LOG_LEVEL", "INFO").upper())
    root.propagate = False
    _configured = True


def get_logger(name: str) -> logging.Logger:
    _configure()
    return logging.getLogger(f"srt.{name}")


def kv(**fields) -> str:
    """Render structured fields: kv(a=1, b="x") -> 'a=1 b=x'."""
    return " ".join(f"{k}={v}" for k, v in fields.items())
