"""Wire-side load generation: the serve/driver.py harnesses over HTTP.

A copy of the JAX package's ``fleet/loadgen.py``.

:class:`WireEngine` adapts the fleet's blocking wire client to the
``submit(session_id, obs, callback=) -> handle`` surface the existing
closed/open-loop measurement harnesses (serve/driver.py) drive — so the
fleet's saturation/p99 numbers come from the SAME harness code and the
SAME quantile convention as the in-process serving numbers, with only the
transport swapped. ``workers`` threads each own one persistent
keep-alive connection (the connection-per-thread contract of
:class:`~sharetrade_tpu_torch.fleet.wire.FleetClient`); the submit queue is
unbounded host-side but the harnesses bound in-flight work at their
concurrency, exactly like the in-process engine path.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Callable

import numpy as np

from sharetrade_tpu_torch.fleet.wire import FleetClient
from sharetrade_tpu_torch.serve.engine import ServeResult
from sharetrade_tpu_torch.utils.logging import get_logger

log = get_logger("fleet.loadgen")

_SHUTDOWN = object()


class _WireHandle:
    __slots__ = ("_event", "result", "error")

    def __init__(self):
        self._event = threading.Event()
        self.result: ServeResult | None = None
        self.error: BaseException | None = None

    def wait(self, timeout: float | None = None) -> ServeResult | None:
        self._event.wait(timeout)
        return self.result


class WireEngine:
    """See the module docstring. ``deadline_ms`` applies to every
    submitted request (0 = none) — the wire header the engine-side gate
    enforces."""

    def __init__(self, host: str, port: int, *, workers: int = 32,
                 deadline_ms: float = 0.0, timeout_s: float = 30.0):
        self.host, self.port = host, int(port)
        self.deadline_ms = float(deadline_ms)
        self.timeout_s = float(timeout_s)
        self._q: queue.Queue = queue.Queue()
        #: Outstanding = submitted but not yet completed (queue depth
        #: alone misses items a worker has popped and is mid-request
        #: on — drain() must wait for BOTH).
        self._outstanding = 0
        self._out_cv = threading.Condition()
        self._stopped = threading.Event()
        self._threads = [
            threading.Thread(target=self._worker, name=f"wire-{i}",
                             daemon=True)
            for i in range(max(1, int(workers)))]
        for t in self._threads:
            t.start()

    def submit(self, session_id: Any, obs: Any,
               callback: Callable | None = None) -> _WireHandle:
        if self._stopped.is_set():
            raise RuntimeError("wire engine is stopped")
        handle = _WireHandle()
        item = (str(session_id), np.asarray(obs, np.float32), callback,
                handle)
        with self._out_cv:
            self._outstanding += 1
        self._q.put(item)
        return handle

    def _worker(self) -> None:
        client = FleetClient(self.host, self.port, timeout_s=self.timeout_s)
        try:
            while True:
                item = self._q.get()
                if item is _SHUTDOWN:
                    return
                session, obs, callback, handle = item
                result = None
                try:
                    t0 = time.perf_counter()
                    reply = client.submit(
                        session, obs,
                        deadline_ms=self.deadline_ms or None)
                    # latency_ms is the CLIENT-OBSERVED wire round trip
                    # (what a fleet p99 means); the engine's internal
                    # decomposition rides along in stages.
                    wire_ms = (time.perf_counter() - t0) * 1e3
                    stages = reply.get("stages") or {}
                    stages["engine_ms"] = float(reply["latency_ms"])
                    result = ServeResult(
                        session_id=reply.get("session", session),
                        action=int(reply["action"]),
                        logits=np.asarray(reply["logits"], np.float32),
                        value=float(reply["value"]),
                        params_step=int(reply["params_step"]),
                        latency_ms=wire_ms,
                        stages=stages)
                except Exception as exc:    # noqa: BLE001 — every wire
                    # outcome (rejection, deadline, transport) completes
                    # the handle; the harness counts it as failed.
                    handle.error = exc
                handle.result = result
                handle._event.set()
                if callback is not None:
                    try:
                        callback(result)
                    except Exception:   # noqa: BLE001
                        log.exception("wire result callback failed")
                with self._out_cv:
                    self._outstanding -= 1
                    if self._outstanding == 0:
                        self._out_cv.notify_all()
        finally:
            client.close()

    def drain(self, timeout_s: float = 30.0) -> bool:
        """Block until every submitted request has COMPLETED (not merely
        been dequeued); False on timeout."""
        deadline = time.monotonic() + timeout_s
        with self._out_cv:
            while self._outstanding > 0:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._out_cv.wait(remaining)
        return True

    def stop(self, **_kw) -> bool:
        self._stopped.set()
        for _ in self._threads:
            self._q.put(_SHUTDOWN)
        for t in self._threads:
            t.join(timeout=10.0)
        return all(not t.is_alive() for t in self._threads)
