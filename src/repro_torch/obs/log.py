"""``repro_torch.obs.log`` — the framework's diagnostic logger.

Library code gets its channel with::

    from repro_torch.obs.log import get_logger
    log = get_logger(__name__)          # -> logging.Logger "repro_torch.core.costs"
    log.info("warm start from neighbor %s", point)

Diagnostics go to **stderr** (stdout belongs to the CLIs' human-readable
summaries), formatted ``[repro_torch.<module>] message``.  The channel level is
controlled by ``REPRO_LOG``:

* ``debug`` — everything, including per-candidate eval lines,
* ``info``  — the default: warm starts, skips, quarantines, db notices,
* ``quiet`` — errors only.

The handler resolves ``sys.stderr`` at emit time (not at import), so
test harnesses that swap the stream (pytest ``capsys``) capture log output
like any other write.  ``logging``'s own propagation/levels still apply:
applications embedding the library can attach their own handlers to the
``"repro_torch"`` logger and call :func:`set_level` (or mutate the logger) freely.
"""
from __future__ import annotations

import logging
import os
import sys
import threading

__all__ = ["get_logger", "set_level", "LEVELS"]

LEVELS = {
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "quiet": logging.ERROR,
}

_ROOT_NAME = "repro_torch"
_lock = threading.Lock()
_configured = False


class _LiveStderrHandler(logging.StreamHandler):
    """StreamHandler bound to *whatever* ``sys.stderr`` currently is."""

    def __init__(self) -> None:
        logging.Handler.__init__(self)

    @property
    def stream(self):  # type: ignore[override]
        return sys.stderr

    @stream.setter
    def stream(self, value) -> None:  # StreamHandler.setStream compatibility
        pass


def _ensure_configured() -> logging.Logger:
    global _configured
    root = logging.getLogger(_ROOT_NAME)
    if _configured:
        return root
    with _lock:
        if _configured:
            return root
        handler = _LiveStderrHandler()
        handler.setFormatter(logging.Formatter("[%(name)s] %(message)s"))
        root.addHandler(handler)
        root.propagate = False  # stderr once, not again via the root logger
        spec = os.environ.get("REPRO_LOG", "info").strip().lower()
        root.setLevel(LEVELS.get(spec, logging.INFO))
        _configured = True
    return root


def set_level(spec: str) -> None:
    """Set the framework channel level: ``debug`` | ``info`` | ``quiet``
    (or any :mod:`logging` level name)."""
    root = _ensure_configured()
    level = LEVELS.get(spec.strip().lower())
    if level is None:
        level = logging.getLevelName(spec.strip().upper())
        if not isinstance(level, int):
            raise ValueError(f"unknown log level {spec!r}")
    root.setLevel(level)


def get_logger(name: str) -> logging.Logger:
    """The diagnostic channel for ``name`` (module path), rooted under
    ``repro_torch`` so one handler and one ``REPRO_LOG`` level govern them all."""
    _ensure_configured()
    if name == _ROOT_NAME or name.startswith(_ROOT_NAME + "."):
        return logging.getLogger(name)
    return logging.getLogger(f"{_ROOT_NAME}.{name}")
