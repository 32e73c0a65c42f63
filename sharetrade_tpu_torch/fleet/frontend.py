"""Network front-end: ``ServeEngine.submit`` exposed over a wire.

Two interchangeable wire backends serve the same protocol (fleet/
wire.py) over any BACKEND object with the two-method surface

- ``serve_request(session, obs, deadline_ms) -> dict`` — blocking; raises
  the serving exceptions (mapped to distinct wire statuses), and
- ``health() -> dict`` — the ``/healthz`` snapshot;

plus ``/metrics`` rendered live from a :class:`~sharetrade_tpu_torch.utils.
metrics.MetricsRegistry`. A copy of the JAX package's ``fleet/frontend.py``
without its trace spans (they wait for ``obs.enabled``). Two backends
exist: :class:`EngineBackend`
(this module — a local engine, what ``cli serve --listen`` runs) and the
router's proxy (fleet/router.py) — the fleet's public port is literally
this same server over a different backend.

The wire backends (``fleet.wire_backend``):

- ``"evloop"`` (default) — fleet/evloop.py: one selector thread, no
  thread per connection or in-flight request — the scalable data path.
- ``"threaded"`` — :class:`ThreadedServeFrontend` below: a stdlib
  ThreadingHTTPServer, one handler thread per connection. Retained as
  the differential-testing ORACLE: both backends render replies through
  fleet/proto.py, so for the same request stream their response bytes
  are identical.

:func:`ServeFrontend` is the factory both spellings go through.

Deadline propagation: the client's ``X-Deadline-Ms`` header flows into
``submit(deadline_ms=)`` — the ENGINE's batch-collection gate expires it
(``ServeDeadlineExceeded`` → 504), never this layer's clock; the
front-end's own ``request_timeout_s`` bounds only a request's life
against a wedged engine (and maps to 503, the "engine gone" truth).

Drain contract (the ``cli serve`` SIGTERM contract over a wire): `drain()`
stops the listener — new connections are refused at the TCP layer, the
OS-visible "draining" signal a fleet router reacts to — then waits for
every in-flight request to finish; the process then exits 75.

fleet-net-ok: this module IS the fleet's network layer — the one place
the lint allows listeners in (tools/lint_hot_loop.py check 14).
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from sharetrade_tpu_torch.fleet import proto, wire
from sharetrade_tpu_torch.obs.exporter import render_prom_text
from sharetrade_tpu_torch.serve.engine import ServeEngineFailed
from sharetrade_tpu_torch.utils.logging import get_logger

log = get_logger("fleet.frontend")


class EngineBackend:
    """The local-engine backend: one blocking wire request ↔ one
    ``engine.submit`` + ``handle.wait`` (threaded backend), or one
    ``submit_async`` parked on the engine's completion callback
    (evloop backend) — identical validation and result payloads."""

    #: Frontends pass the parsed ``X-Session-Clock`` header (the
    #: router-observed completed-response count) only to backends that
    #: declare it — the engine validates a spill record's step stamp
    #: against it before adopting the carry.
    wire_clocked = True

    def __init__(self, engine, *, request_timeout_s: float = 30.0):
        self.engine = engine
        self.request_timeout_s = float(request_timeout_s)

    @staticmethod
    def validate_obs(obs) -> np.ndarray:
        obs = np.asarray(obs, np.float32)
        if obs.ndim != 1 or obs.size < 3:
            raise ValueError(
                f"obs must be a flat (window + portfolio) vector, got "
                f"shape {obs.shape}")
        if not np.all(np.isfinite(obs)):
            raise ValueError("obs contains non-finite values")
        return obs

    @staticmethod
    def result_dict(result) -> dict:
        return {
            "session": result.session_id,
            "action": int(result.action),
            "logits": [float(x) for x in np.asarray(result.logits)],
            "value": float(result.value),
            "params_step": int(result.params_step),
            "latency_ms": float(result.latency_ms),
            "stages": result.stages,
        }

    def _submit(self, session: str, obs, deadline_ms, callback=None,
                clock=None):
        return self.engine.submit(session, obs, callback=callback,
                                  deadline_ms=deadline_ms or 0.0,
                                  session_clock=clock)

    def serve_request(self, session: str, obs,
                      deadline_ms: float | None,
                      clock: int | None = None) -> dict:
        obs = self.validate_obs(obs)
        handle = self._submit(session, obs, deadline_ms, clock=clock)
        # A deadline'd request resolves engine-side well inside
        # deadline + one batch; the no-deadline wait is bounded by the
        # configured front-end budget so a wedged engine surfaces as a
        # loud 503 instead of an immortal handler thread.
        timeout = (max(float(deadline_ms) / 1e3 * 4, 5.0) if deadline_ms
                   else self.request_timeout_s)
        result = handle.wait(timeout)
        if result is None:
            if handle.error is not None:
                raise handle.error
            raise ServeEngineFailed(
                f"request did not complete within the front-end "
                f"budget ({timeout:.1f}s)")
        return self.result_dict(result)

    def submit_async(self, session: str, obs, deadline_ms: float | None,
                     signal_done, clock: int | None = None):
        """The evloop front-end's dispatch: validate and enqueue, then
        return the request handle WITHOUT waiting — ``signal_done()``
        fires (from the engine's consumer thread) once the handle
        completes; read ``handle.result`` / ``handle.error`` after."""
        obs = self.validate_obs(obs)
        return self._submit(session, obs, deadline_ms,
                            callback=lambda _result: signal_done(),
                            clock=clock)

    def health(self) -> dict:
        engine = self.engine
        reg = engine.registry
        refresh = getattr(engine, "refresh_spill_gauges", None)
        if refresh is not None:
            # The scrape IS the stats clock while the engine idles: the
            # router reads health then /metrics each poll, and the spill
            # census must be live in that same poll even with no batch
            # completing (cadence-gated inside — one bounded scandir).
            refresh()
        return {
            "ok": engine.failed is None,
            "failed": engine.failed is not None,
            "queue_depth": int(engine.queue_depth()),
            "overload": float(reg.latest("serve_overload", 0.0) or 0.0),
            "params_step": int(engine.params_step),
            "swaps_total": int(
                reg.counters().get("serve_swaps_total", 0)),
        }


class _FrontendServer(ThreadingHTTPServer):
    # fleet-net-ok: the fleet's threaded listener implementation.
    daemon_threads = True
    allow_reuse_address = True
    # Match the evloop listener's backlog so a connection-storm bench
    # measures the thread-per-connection cost, not accept-queue drops.
    request_queue_size = 1024

    def __init__(self, addr, handler, frontend: "ThreadedServeFrontend"):
        super().__init__(addr, handler)
        self.frontend = frontend


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"       # keep-alive: the perf floor
    server_version = "sharetrade-fleet"

    def log_message(self, fmt, *args):   # request logging is telemetry's
        pass                             # job, not stderr's

    # -- plumbing ---------------------------------------------------------

    def _reply(self, status: int, body: dict | bytes,
               content_type: str = "application/json") -> None:
        payload = (body if isinstance(body, bytes)
                   else json.dumps(body).encode())
        try:
            # Rendered by the shared sans-IO renderer — byte-identical
            # to the evloop backend's replies (the differential-oracle
            # contract), not send_response's Server/Date decoration.
            self.wfile.write(proto.render_response(status, payload,
                                                   content_type))
        except (BrokenPipeError, ConnectionResetError):
            # The client hung up mid-reply (teardown, a canceled
            # request): its socket is the only casualty — never the
            # handler thread or the error log.
            self.close_connection = True

    # -- verbs ------------------------------------------------------------

    def do_POST(self):
        fe = self.server.frontend
        # Consume the body UNCONDITIONALLY before any reply: an early
        # 404/503 that leaves it unread poisons the next keep-alive
        # request on this connection (the leftover bytes parse as a
        # garbage request line). The length check itself is proto's —
        # one definition of a well-formed Content-Length on the wire.
        try:
            length = proto.content_length(
                self.headers.get("Content-Length"))
        except proto.ProtocolError as exc:
            self._reply(exc.status, {"error": "bad_request",
                                     "detail": exc.detail})
            self.close_connection = True
            return
        raw = self.rfile.read(length)
        if self.path != wire.SUBMIT_PATH:
            self._reply(404, {"error": "not_found"})
            return
        with fe._inflight_cv:
            draining = fe.draining
            if not draining:
                fe._inflight += 1
        if draining:
            # Connections accepted before the listener closed still get
            # a loud, distinct refusal instead of a hang — written OFF
            # the condition lock: a stalled client's full TCP buffer
            # must block only its own handler, never every thread
            # waiting to bump the in-flight count.
            self._reply(wire.STATUS_UNAVAILABLE,
                        {"error": "engine_failed",
                         "detail": "front-end is draining"})
            return
        try:
            deadline_raw = self.headers.get(wire.DEADLINE_HEADER)
            proxy = getattr(fe.backend, "proxy_request", None)
            if proxy is not None:
                # Thin-relay fast path (the router): only the session id
                # is extracted — the body is forwarded and the reply
                # relayed as BYTES, so the proxy hop never pays a JSON
                # round-trip (the router-thinner-than-an-engine premise).
                try:
                    session = wire.extract_session(raw)
                except ValueError as exc:
                    self._reply(*wire.error_to_status(exc))
                    return
                try:
                    status, reply = proxy(session, raw, deadline_raw)
                except Exception as exc:    # noqa: BLE001
                    status, reply = wire.error_to_status(exc)
                    if status == 500:
                        log.exception("router relay failed internally")
                self._reply(status, reply)
                return
            try:
                payload = json.loads(raw)
                session = payload["session"]
                obs = payload["obs"]
            except (ValueError, KeyError, TypeError) as exc:
                self._reply(*wire.error_to_status(
                    ValueError(f"malformed submit body: {exc!r}")))
                return
            deadline_ms = None
            if deadline_raw is not None:
                try:
                    deadline_ms = float(deadline_raw)
                except ValueError:
                    self._reply(*wire.error_to_status(ValueError(
                        f"malformed {wire.DEADLINE_HEADER}: "
                        f"{deadline_raw!r}")))
                    return
            clock = None
            clock_raw = self.headers.get(wire.CLOCK_HEADER)
            if clock_raw is not None and getattr(
                    fe.backend, "wire_clocked", False):
                try:
                    clock = int(clock_raw) or None
                except ValueError:
                    self._reply(*wire.error_to_status(ValueError(
                        f"malformed {wire.CLOCK_HEADER}: "
                        f"{clock_raw!r}")))
                    return
            fe.registry.inc("frontend_requests_total")
            kwargs = {"clock": clock} if clock is not None else {}
            try:
                result = fe.backend.serve_request(session, obs,
                                                  deadline_ms, **kwargs)
            except Exception as exc:    # noqa: BLE001 — every serving
                # outcome maps to a wire status; the handler never dies.
                status, body = wire.error_to_status(exc)
                if status == 500:
                    log.exception("front-end request failed internally")
                fe.registry.inc("frontend_errors_total")
                self._reply(status, body)
                return
            self._reply(wire.STATUS_OK, result)
        finally:
            with fe._inflight_cv:
                fe._inflight -= 1
                fe._inflight_cv.notify_all()

    def do_GET(self):
        fe = self.server.frontend
        if self.path == wire.HEALTH_PATH:
            try:
                body = fe.backend.health()
            except Exception as exc:    # noqa: BLE001
                self._reply(wire.STATUS_UNAVAILABLE,
                            {"ok": False, "detail": repr(exc)})
                return
            body["draining"] = fe.draining
            self._reply(wire.STATUS_OK, body)
        elif self.path == wire.METRICS_PATH:
            reg = fe.registry
            text = render_prom_text(reg.snapshot(), reg.counters(),
                                    reg.histograms())
            self._reply(wire.STATUS_OK, text.encode(),
                        content_type="text/plain; version=0.0.4")
        else:
            self._reply(404, {"error": "not_found"})


class ThreadedServeFrontend:
    """The thread-per-connection wire backend (module docstring).
    ``port=0`` binds an ephemeral port; read :attr:`port` after
    construction for the actual one."""

    def __init__(self, backend, registry, *, host: str = "127.0.0.1",
                 port: int = 0):
        self.backend = backend
        self.registry = registry
        self.draining = False
        self._inflight = 0
        self._inflight_cv = threading.Condition()
        self._server = _FrontendServer((host, port), _Handler, self)
        self.host, self.port = self._server.server_address[:2]
        self._thread: threading.Thread | None = None

    def start(self) -> "ThreadedServeFrontend":
        # Which parse/render implementation is live behind proto.py
        # (native C or Python) — same gauge the evloop records, so
        # /metrics names the wire path under either backend.
        self.registry.record(
            "fleet_proto_backend_native",
            1.0 if proto.proto_backend == "native" else 0.0)
        self._thread = threading.Thread(
            target=self._server.serve_forever,
            kwargs={"poll_interval": 0.1},
            name="fleet-frontend", daemon=True)
        self._thread.start()
        log.info("front-end listening on %s:%d", self.host, self.port)
        return self

    def drain(self, timeout_s: float = 30.0) -> bool:
        """Stop accepting, finish in-flight handlers; False on timeout."""
        self.draining = True
        self._server.shutdown()         # closes the accept loop
        deadline = time.monotonic() + timeout_s
        with self._inflight_cv:
            while self._inflight > 0:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._inflight_cv.wait(remaining)
        return True

    def stop(self, timeout_s: float = 10.0) -> None:
        if not self.draining:
            self.draining = True
            self._server.shutdown()
        self._server.server_close()
        if self._thread is not None:
            self._thread.join(timeout_s)


def ServeFrontend(backend, registry, *, host: str = "127.0.0.1",
                  port: int = 0, wire_backend: str | None = None):
    """Build a wire front-end — the one construction surface both
    backends share (``FleetConfig.wire_backend`` plumbs through here).
    ``None`` means the default backend (evloop)."""
    wire_backend = wire_backend or "evloop"
    if wire_backend == "evloop":
        from sharetrade_tpu_torch.fleet.evloop import EvloopFrontend
        return EvloopFrontend(backend, registry, host=host, port=port)
    if wire_backend == "threaded":
        return ThreadedServeFrontend(backend, registry, host=host,
                                     port=port)
    raise ValueError(
        f"unknown fleet.wire_backend {wire_backend!r} "
        f"(expected 'evloop' or 'threaded')")
