"""Host-side span tracer emitting Chrome trace-event JSON, and the
cross-process span journal of the fleet.

The counterpart of the JAX package's ``obs/trace.py``, in the same file
formats byte for byte, so a reader of either package reads the other's
files and a collector of either package stitches the other's journals.

:class:`SpanTracer` is the HOST timeline: orchestrator phases (dispatch,
readback, host processing, checkpoint IO, supervision recovery) and the
serve engine's request lifecycles written as Chrome trace events that
Perfetto (https://ui.perfetto.dev) or chrome://tracing load directly. Device
time is not in it: a ``dispatch`` span around a CUDA graph replay times the
enqueue; the chunk program's CUDA events time the device.

File format: the JSON Array Format of the Trace Event spec — an opening
``[`` then one ``{event},`` per line. The spec makes the closing ``]``
optional, so a crashed writer still leaves a loadable trace, and every
event is one self-contained line. Events are buffered and flushed every
``flush_every`` records (and on close), so the hot loop pays a dict and an
append, not a syscall, per span.

``SpanTracer(None)`` is the disabled instance: ``span()`` returns a shared
null context and nothing is ever opened or written.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from collections import deque
from typing import Any

from sharetrade_tpu_torch.data.journal import frame_record, segment_paths

_NULL_CTX = contextlib.nullcontext()


class _Span:
    """One in-flight span; emits a complete ("ph": "X") event on exit."""

    __slots__ = ("_tracer", "_name", "_args", "_t0")

    def __init__(self, tracer: "SpanTracer", name: str, args: dict):
        self._tracer = tracer
        self._name = name
        self._args = args

    def __enter__(self) -> "_Span":
        self._t0 = self._tracer._now_us()
        return self

    def __exit__(self, *exc) -> None:
        t1 = self._tracer._now_us()
        self._tracer._emit({
            "name": self._name, "ph": "X", "ts": self._t0,
            "dur": t1 - self._t0, "pid": self._tracer._pid,
            "tid": threading.get_ident(),
            **({"args": self._args} if self._args else {}),
        })


class SpanTracer:
    def __init__(self, path: str | None, *, flush_every: int = 64):
        self._path = path
        self._flush_every = max(1, flush_every)
        self._lock = threading.Lock()
        self._buf: list[str] = []
        self._pid = os.getpid()
        # Trace timestamps are microseconds on the perf_counter clock from
        # tracer construction (Perfetto only needs them monotone/relative);
        # wall-clock anchoring lives in the run manifest.
        self._t0 = time.perf_counter()
        self._fh = None
        if path:
            self._fh = open(path, "w", encoding="utf-8")
            self._fh.write("[\n")

    @property
    def enabled(self) -> bool:
        return self._fh is not None

    def _now_us(self) -> float:
        return (time.perf_counter() - self._t0) * 1e6

    def span(self, name: str, **args: Any):
        """Context manager timing one named phase; no-op when disabled."""
        if self._fh is None:
            return _NULL_CTX
        return _Span(self, name, args)

    def instant(self, name: str, **args: Any) -> None:
        """Zero-duration marker (lifecycle transitions, dumps, restarts)."""
        if self._fh is None:
            return
        self._emit({
            "name": name, "ph": "i", "ts": self._now_us(), "s": "p",
            "pid": self._pid, "tid": threading.get_ident(),
            **({"args": args} if args else {}),
        })

    def to_us(self, t_perf: float) -> float:
        """A raw ``time.perf_counter()`` stamp on this tracer's timeline —
        for RETROSPECTIVE emission (the serve engine stamps request edges
        as floats and emits the whole lifecycle at completion)."""
        return (t_perf - self._t0) * 1e6

    @property
    def pid(self) -> int:
        return self._pid

    def emit_lines(self, lines: list[str]) -> None:
        """Bulk-append PRE-SERIALIZED event lines (no trailing comma/
        newline) under one lock acquisition — the per-request hot path.
        The serve engine formats its request-lifecycle events with
        f-strings instead of per-event ``json.dumps`` (measured ~10x
        cheaper at 5 events/request on the completion thread); callers
        own the validity of what they hand in (tests round-trip it
        through :func:`read_trace`)."""
        with self._lock:
            if self._fh is None:
                return
            self._buf.extend(lines)
            if len(self._buf) >= self._flush_every:
                self._flush_locked()

    def _emit(self, event: dict) -> None:
        with self._lock:
            if self._fh is None:
                return
            self._buf.append(json.dumps(event))
            if len(self._buf) >= self._flush_every:
                self._flush_locked()

    def _flush_locked(self) -> None:
        if self._buf and self._fh is not None:
            self._fh.write("".join(line + ",\n" for line in self._buf))
            self._fh.flush()
            self._buf.clear()

    def flush(self) -> None:
        with self._lock:
            self._flush_locked()

    def close(self) -> None:
        with self._lock:
            self._flush_locked()
            if self._fh is not None:
                self._fh.close()
                self._fh = None


# ---------------------------------------------------------------------------
# Cross-process wire spans: every fleet process journals its
# finished spans to a bounded per-process CRC-framed file; obs/collect.py
# stitches them by trace id into one Perfetto trace. Timestamps are raw
# ``time.perf_counter()`` floats — processes do NOT share that clock, so
# each journal records a monotonic→epoch anchor the collector aligns with.


def new_trace_id() -> str:
    """A fresh 16-hex-char trace id (random, collision-free in practice);
    minted once per inbound request at whichever hop first finds no
    ``X-Trace-Id`` header (the client when traced, else the frontend)."""
    return os.urandom(8).hex()


class SpanJournal:
    """Bounded per-process span journal: CRC-framed batches, segment
    rotation, oldest-first pruning — the data/journal.py frame (ONE
    framing definition; every file replays through
    ``iter_framed_records``) without its writer-lock/fsync weight: span
    files are keyed by (process label, pid) so two writers can never
    share one, and spans are telemetry — a torn tail loses at most the
    last unflushed batch, never correctness.

    Clock contract (the correctness core the collector leans on): at
    open, ONE ``(epoch=time.time(), mono=time.perf_counter())`` pair is
    captured — the tightest of several samples, so the pairing error is
    bounded by the narrowest observed sampling window — and a clock line
    carrying it leads EVERY flushed batch payload. Each record is
    therefore self-describing: segment pruning or a torn tail can never
    orphan spans from their alignment offset."""

    def __init__(self, directory: str, proc: str, *,
                 max_records: int = 4096, max_segments: int = 8):
        self.dir = directory
        self.proc = proc
        self.pid = os.getpid()
        os.makedirs(directory, exist_ok=True)
        self.path = os.path.join(directory,
                                 f"spans-{proc}-{self.pid}.journal")
        best = None
        for _ in range(5):
            a = time.perf_counter()
            epoch = time.time()
            b = time.perf_counter()
            if best is None or (b - a) < best[2]:
                best = (epoch, (a + b) / 2.0, b - a)
        self.epoch, self.mono = best[0], best[1]
        self._clock_line = json.dumps(
            {"clock": 1, "proc": proc, "pid": self.pid,
             "epoch": self.epoch, "mono": self.mono},
            separators=(",", ":")).encode()
        self._max_records = max(1, int(max_records))
        self._max_segments = max(1, int(max_segments))
        self._records = 0
        self._lock = threading.Lock()
        self._fh = open(self.path, "ab")

    def append_batch(self, lines: list[bytes]) -> None:
        """Append ONE framed record: the clock line plus ``lines``
        (newline-joined pre-serialized span events). Flushed to the OS
        immediately — the page cache survives a SIGKILLed writer, which
        is what lets a dead engine's ingress spans reach the stitched
        trace of a migrated request."""
        payload = b"\n".join([self._clock_line, *lines])
        record = frame_record(payload)
        with self._lock:
            if self._fh is None:
                return
            self._fh.write(record)
            self._fh.flush()
            self._records += 1
            if self._records >= self._max_records:
                self._rotate_locked()

    def _rotate_locked(self) -> None:
        self._fh.close()
        existing = segment_paths(self.path)
        last = int(existing[-1].rsplit(".seg", 1)[1]) if existing else 0
        os.rename(self.path, f"{self.path}.seg{last + 1:08d}")
        for stale in segment_paths(self.path)[:-self._max_segments]:
            try:
                os.unlink(stale)
            except OSError:
                pass
        self._fh = open(self.path, "ab")
        self._records = 0

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None


class SpanSink:
    """Hot-path wire-span buffer: one tuple append per finished span into
    a BOUNDED ring, serialization deferred to the batched flush (one
    ``json.dumps`` per span at flush cadence, one framed journal append
    per batch), the emission discipline of the evloop runner and the
    router's relay closures. Overflow drops
    the oldest spans (counted in ``dropped``) instead of growing."""

    def __init__(self, journal: SpanJournal, *, capacity: int = 8192,
                 flush_every: int = 128):
        self._journal = journal
        self._flush_every = max(1, int(flush_every))
        # trace-buffer-ok: bounded ring (maxlen); overflow counted, not grown
        self._buf: deque = deque(maxlen=max(self._flush_every,
                                            int(capacity)))
        self._lock = threading.Lock()
        self._ids = itertools.count(1)
        self._id_prefix = f"{journal.pid:x}"
        self.proc = journal.proc
        self.dropped = 0

    def new_span_id(self) -> str:
        """Pid-prefixed counter hex — unique across processes without
        per-span entropy syscalls."""
        return f"{self._id_prefix}.{next(self._ids):x}"

    def span(self, trace_id: str, span_id: str, parent: str, name: str,
             t0: float, t1: float | None, note: str = "") -> None:
        """Record one finished span (``t0``/``t1`` on this process's
        ``perf_counter`` clock; ``t1=None`` = instant event)."""
        with self._lock:
            buf = self._buf
            if len(buf) == buf.maxlen:
                self.dropped += 1
            buf.append((trace_id, span_id, parent, name, t0, t1, note))
            if len(buf) >= self._flush_every:
                self._flush_locked()

    def instant(self, trace_id: str, span_id: str, parent: str, name: str,
                note: str = "", *, flush: bool = False) -> None:
        """Zero-duration marker at now; ``flush=True`` makes it DURABLE
        before returning (the engine-ingress eager flush: a SIGKILLed
        engine must still leave trace evidence for in-flight requests)."""
        self.span(trace_id, span_id, parent, name,
                  time.perf_counter(), None, note)
        if flush:
            self.flush()

    def _flush_locked(self) -> None:
        if not self._buf:
            return
        lines = []
        for trace_id, span_id, parent, name, t0, t1, note in self._buf:
            ev: dict = {"trace": trace_id, "span": span_id,
                        "parent": parent, "name": name, "t0": t0}
            if t1 is not None:
                ev["t1"] = t1
            if note:
                ev["note"] = note
            lines.append(json.dumps(ev, separators=(",", ":")).encode())
        self._buf.clear()
        self._journal.append_batch(lines)

    def flush(self) -> None:
        with self._lock:
            self._flush_locked()

    def close(self) -> None:
        self.flush()
        self._journal.close()


def read_trace(path: str) -> list[dict]:
    """Parse a (possibly unterminated) JSON-Array-Format trace back into
    event dicts — the reader the `cli obs` summary and tests share."""
    with open(path, encoding="utf-8") as f:
        content = f.read()
    content = content.strip()
    if not content or content == "[":
        return []
    if not content.endswith("]"):
        content = content.rstrip(",") + "]"
    return json.loads(content)
