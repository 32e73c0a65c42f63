"""Structured logging.

The reference uses logback + akka-slf4j with `ActorLogging` mixed into every
actor (reference build.sbt:15-16, application.conf:1-3). Here: stdlib logging
with one consistent formatter, plus an optional JSONL event stream for machine
consumption (the observability surface the reference lacks, SURVEY.md §5).

PyTorch port: a verbatim copy of the JAX package's logging module, so that
both packages log under the same ``sharetrade.*`` logger names and format.
"""

from __future__ import annotations

import json
import logging
import sys
import threading
import time
from typing import Any

_FORMAT = "%(asctime)s %(levelname)-7s [%(name)s] %(message)s"
_configured = False
_lock = threading.Lock()


def configure(level: int | None = None, stream=None) -> None:
    """Idempotent setup; explicit re-calls update level/stream (imports latch
    the handler early via get_logger, so this must not be first-call-wins).
    ``level=None`` means "leave as-is" (INFO on first call)."""
    global _configured
    with _lock:
        root = logging.getLogger("sharetrade")
        if not _configured:
            handler = logging.StreamHandler(stream or sys.stderr)
            handler.setFormatter(logging.Formatter(_FORMAT))
            root.addHandler(handler)
            root.propagate = False
            root.setLevel(logging.INFO if level is None else level)
            _configured = True
            return
        if stream is not None:
            for h in list(root.handlers):
                root.removeHandler(h)
            handler = logging.StreamHandler(stream)
            handler.setFormatter(logging.Formatter(_FORMAT))
            root.addHandler(handler)
        if level is not None:
            root.setLevel(level)


def get_logger(name: str) -> logging.Logger:
    configure()
    return logging.getLogger(f"sharetrade.{name}")


class EventLog:
    """Append-only JSONL event stream for structured run events.

    Used by the runtime for lifecycle transitions, restarts, checkpoints —
    the machine-readable counterpart of the reference's lifecycle log lines
    (e.g. TrainerRouterActor.scala:70,87,128).

    ``mirror`` (settable post-construction) receives every emitted event as
    ``mirror(kind, payload)`` even when no file is attached — the tap the
    obs flight recorder rides so supervision/lifecycle events land in the
    crash ring without a second emit call at every site.
    """

    def __init__(self, path: str | None):
        self._path = path
        self._lock = threading.Lock()
        self._fh = open(path, "a", buffering=1) if path else None
        self.mirror: Any | None = None

    def emit(self, kind: str, **payload: Any) -> None:
        if self.mirror is not None:
            try:
                self.mirror(kind, payload)
            except Exception:
                pass        # a broken tap must never block the event log
        if self._fh is None:
            return
        record = {"ts": time.time(), "kind": kind, **payload}
        with self._lock:
            self._fh.write(json.dumps(record) + "\n")

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None
