"""Crash flight recorder: a bounded ring of recent run events.

Black-box style: the orchestrator continuously records cheap host-side facts
— sampled chunk metric rows, lifecycle transitions, structured run events
(the EventLog mirror) and WARNING+ log lines — into a fixed-size deque.
Nothing touches disk until something goes wrong; when supervision trips, the
NaN-loss guard fires, or the run escalates, :meth:`dump` writes the whole
ring plus failure context as one forensic JSON bundle
(``flight_recorder.json``), so the last-K chunks before a crash are
reconstructable without per-chunk logging overhead during healthy runs.

The counterpart of the JAX package's ``obs/flight.py``, with the same bundle
format. Both packages log under the ``sharetrade`` logger, so in a process
that holds both a :class:`RingLogHandler` sees the log lines of either.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from collections import deque
from typing import Any


class FlightRecorder:
    def __init__(self, capacity: int = 256):
        self._ring: deque[dict] = deque(maxlen=max(1, int(capacity)))
        self._lock = threading.Lock()
        #: Chunk index of the most recent ``chunk_metrics`` record — at dump
        #: time this IS the failing chunk (rows are recorded before the
        #: fault hook / health checks that can raise on them).
        self.last_chunk: int | None = None
        self.dumps = 0

    def record(self, kind: str, **payload: Any) -> None:
        if kind == "chunk_metrics" and "chunk" in payload:
            self.last_chunk = int(payload["chunk"])
        with self._lock:
            self._ring.append({"ts": time.time(), "kind": kind, **payload})

    def snapshot(self) -> list[dict]:
        with self._lock:
            return list(self._ring)

    def dump(self, path: str, *, reason: str, **context: Any) -> str:
        """Write the forensic bundle atomically (tmp + rename, the
        checkpoint/journal crash-safety contract); returns the path."""
        bundle = {
            "reason": reason,
            "dumped_at": time.time(),
            "failing_chunk": context.pop("failing_chunk", self.last_chunk),
            "context": context,
            "events": self.snapshot(),
        }
        tmp = f"{path}.tmp-{os.getpid()}"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(bundle, f, indent=2, default=str)
        os.replace(tmp, path)
        self.dumps += 1
        return path


class RingLogHandler(logging.Handler):
    """Feeds WARNING+ log records into the flight ring, so the bundle shows
    what the logs said in the window before the crash."""

    def __init__(self, flight: FlightRecorder,
                 level: int = logging.WARNING):
        super().__init__(level=level)
        self._flight = flight

    def emit(self, record: logging.LogRecord) -> None:
        try:
            self._flight.record("log", level=record.levelname,
                                logger=record.name,
                                message=record.getMessage())
        except Exception:   # a broken log record must never kill the run
            pass
