"""The fleet wire protocol — one HTTP/1.1 surface, spoken three times.

Every network hop in the fleet speaks the same tiny protocol: the
end-client talks to the ROUTER, the router talks to each ENGINE worker,
and the supervising pool/telemetry pollers scrape both. Keeping it in
one module (paths, headers, the status↔exception mapping, and the
persistent-connection client) is what makes "the router is just another
client of an engine" literally true in the code.

A copy of the JAX package's ``fleet/wire.py``, so a client or router of
either package talks to a front-end of the other. Its trace spans wait
for ``obs.enabled`` (ROADMAP item 13), as do the front-ends' and the
router's: :class:`FleetClient` refuses a span sink, and never sends the
trace headers.

Endpoints (fleet/frontend.py and fleet/evloop.py serve them over any
``serve_request`` backend — a local :class:`~sharetrade_tpu_torch.serve.
engine.ServeEngine` or the router's proxy):

- ``POST /v1/submit`` — body ``{"session": str, "obs": [float, ...]}``;
  the per-request deadline travels as the ``X-Deadline-Ms`` header and
  flows INTO ``ServeEngine.submit(deadline_ms=)`` engine-side (the
  router forwards it untouched — deadline enforcement belongs to the
  engine's batch-collection gate, never to a proxy's clock). Response
  200 carries the full :class:`~sharetrade_tpu_torch.serve.engine.
  ServeResult` payload (action/logits/value/params_step/latency_ms/stages)
  as JSON; float64 JSON round-trips the float32 logits exactly, so the
  wire adds no error of its own.
- ``GET /healthz`` — small JSON liveness/telemetry snapshot (queue
  depth, overload, params_step, failed) — the router's routing signal
  and the pool's heartbeat.
- ``GET /metrics`` — the standard Prometheus exposition
  (:func:`~sharetrade_tpu_torch.obs.exporter.render_prom_text` over the live
  registry), histograms included — what the router merges bucket-wise
  for exact fleet-level quantiles.

Status mapping (each distinct serving outcome is a distinct wire
status, so a client — including the router — reconstructs the exact
engine-side exception):

====  ==========================  =======================================
code  exception                   meaning
====  ==========================  =======================================
200   —                           served; body is the result
400   ``ValueError``              malformed request (refused pre-engine)
429   ``ServeRejected``           admission refused / shed (reason in
                                  body: queue_full/shed_oldest/...)
503   ``ServeEngineFailed``       engine terminally failed, stopped,
                                  draining, or (router) no live engines
504   ``ServeDeadlineExceeded``   deadline expired engine-side before a
                                  device batch
====  ==========================  =======================================
"""

from __future__ import annotations

import json
import re
import socket
from http.client import HTTPException

from sharetrade_tpu_torch.fleet import proto
from sharetrade_tpu_torch.serve.engine import (
    ServeDeadlineExceeded,
    ServeEngineFailed,
    ServeRejected,
)

SUBMIT_PATH = "/v1/submit"
HEALTH_PATH = "/healthz"
METRICS_PATH = "/metrics"
DEADLINE_HEADER = "X-Deadline-Ms"
#: The session's completed-response count as the ROUTER has observed it:
#: forwarded on every proxy hop so an adopting engine can
#: validate a spill record's step stamp against the session's expected
#: clock — a stale record demotes to cold prefill instead of serving a
#: rolled-back carry.
CLOCK_HEADER = "X-Session-Clock"

STATUS_OK = 200
STATUS_BAD_REQUEST = 400
STATUS_REJECTED = 429
STATUS_UNAVAILABLE = 503
STATUS_DEADLINE = 504

#: Network-layer failures a caller may treat as "this endpoint is gone —
#: reconnect or re-route" (vs a clean protocol-status reply). OSError
#: covers refused/reset/broken-pipe; HTTPException covers the torn
#: keep-alive reads (RemoteDisconnected, BadStatusLine).
TRANSPORT_ERRORS = (OSError, HTTPException)


def error_to_status(exc: BaseException) -> tuple[int, dict]:
    """Map a serving exception to ``(status, body)`` — the single
    server-side encoding of the table above."""
    if isinstance(exc, ServeRejected):
        return STATUS_REJECTED, {"error": "rejected",
                                 "reason": exc.reason,
                                 "detail": str(exc)}
    if isinstance(exc, ServeDeadlineExceeded):
        return STATUS_DEADLINE, {"error": "deadline", "detail": str(exc)}
    if isinstance(exc, ServeEngineFailed):
        return STATUS_UNAVAILABLE, {"error": "engine_failed",
                                    "detail": str(exc)}
    if isinstance(exc, ValueError):
        return STATUS_BAD_REQUEST, {"error": "bad_request",
                                    "detail": str(exc)}
    return 500, {"error": "internal", "detail": repr(exc)}


def status_to_error(status: int, body: dict) -> BaseException:
    """Client-side inverse: reconstruct the engine-side exception from a
    non-200 reply, so code above a :class:`FleetClient` handles wire and
    in-process serving identically."""
    detail = body.get("detail", f"wire status {status}")
    if status == STATUS_REJECTED:
        return ServeRejected(detail,
                             reason=body.get("reason", "queue_full"))
    if status == STATUS_DEADLINE:
        return ServeDeadlineExceeded(detail)
    if status == STATUS_UNAVAILABLE:
        return ServeEngineFailed(detail)
    if status == STATUS_BAD_REQUEST:
        return ValueError(detail)
    return RuntimeError(f"unexpected wire status {status}: {detail}")


#: Fast-path session extraction for the router's byte-level relay: the
#: submit body leads with a plain-string session id in every client this
#: repo ships; anything fancier (escapes, non-string ids) falls back to
#: a real JSON parse.
_SESSION_RE = re.compile(rb'"session"\s*:\s*"([^"\\]*)"')


def extract_session(raw: bytes) -> str:
    """Pull the session id out of a submit body without a full JSON
    round-trip (both wire backends' relay paths use this); raises the
    400-mapped ``ValueError`` on a body with no recoverable session."""
    m = _SESSION_RE.search(raw)
    if m is not None:
        return m.group(1).decode("utf-8", "replace")
    try:
        return str(json.loads(raw)["session"])
    except (ValueError, KeyError, TypeError) as exc:
        raise ValueError(f"malformed submit body: {exc!r}") from exc


class _WireConnError(ConnectionError):
    """A malformed/torn HTTP response on a persistent connection —
    transport-class (the keep-alive is unusable), never protocol-class."""


class FleetClient:
    """Blocking wire client over ONE persistent keep-alive connection.

    NOT thread-safe by design — each worker/handler thread owns its own
    client (the connection-per-thread pattern both the router's proxy
    path and the load harness's :class:`WireEngine` use), so there is no
    lock on the request path. A torn keep-alive (server restarted, idle
    timeout) is retried ONCE on a fresh connection; a second transport
    failure propagates to the caller, which owns the re-route/give-up
    decision.

    Implementation note: this speaks HTTP/1.1 over a RAW socket — one
    ``sendall`` of a prebuilt request, responses framed by the shared
    sans-IO parser (fleet/proto.py) — instead of ``http.client``. Same
    protocol on the wire; ~4-5x less per-request Python, which is the
    difference between the router being thinner than an engine and the
    router being the fleet's bottleneck."""

    def __init__(self, host: str, port: int, *,
                 timeout_s: float = 30.0, sink=None):
        self.host = host
        self.port = int(port)
        self.timeout_s = float(timeout_s)
        self._sock: socket.socket | None = None
        self._parser = proto.ResponseParser()
        # The JAX client's wire-span sink: its spans are not ported, so
        # the obs-disabled wire (no trace headers, no spans) is the only one.
        if sink is not None:
            raise NotImplementedError(
                "FleetClient(sink=...): wire trace spans are not yet ported "
                "to sharetrade_tpu_torch (ROADMAP item 13)")

    def close(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            finally:
                self._sock = None
                self._parser = proto.ResponseParser()

    def _connect(self, timeout_s: float) -> socket.socket:
        # fleet-net-ok: CLIENT socket (outbound connect, no listener).
        sock = socket.create_connection((self.host, self.port),
                                        timeout=timeout_s)
        # One-sendall requests make Nagle pointless and delayed-ACK
        # interplay expensive; serving RPCs always disable it.
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return sock

    def _read_response(self, sock: socket.socket) -> tuple[int, bytes]:
        """One HTTP/1.1 response off the socket, framed by the shared
        sans-IO parser (torn reads, missing/malformed Content-Length
        and oversized heads all handled in ONE place — fleet/proto.py);
        any framing violation is transport-class, the keep-alive is
        unrecoverable."""
        while True:
            chunk = sock.recv(65536)
            if not chunk:
                raise _WireConnError("connection closed mid-response")
            try:
                events = self._parser.feed(chunk)
            except proto.ProtocolError as exc:
                raise _WireConnError(exc.detail) from exc
            if events:
                response = events[0]
                return response.status, response.body

    def _request(self, method: str, path: str,
                 body: bytes | None = None,
                 headers: dict | None = None,
                 timeout_s: float | None = None) -> tuple[int, bytes]:
        body = body or b""
        request = proto.render_request(method, path,
                                       f"{self.host}:{self.port}",
                                       body, headers=headers)
        timeout = timeout_s or self.timeout_s
        attempts = 2            # fresh-connection retry for torn keep-alive
        for attempt in range(attempts):
            fresh = self._sock is None
            if fresh:
                self._sock = self._connect(timeout)
            else:
                self._sock.settimeout(timeout)
            try:
                self._sock.sendall(request)
                return self._read_response(self._sock)
            except TRANSPORT_ERRORS:
                self.close()
                # Retry ONLY a torn keep-alive: a failure on a fresh
                # connection is the peer's true state, and re-sending
                # after response bytes may already have been consumed
                # risks a duplicate.
                if fresh or attempt + 1 >= attempts:
                    raise
        raise AssertionError("unreachable")

    def raw_request(self, path: str, body: bytes,
                    extra_headers: dict | None = None,
                    timeout_s: float | None = None) -> tuple[int, bytes]:
        """Byte-level POST relay (the router's thin-proxy hop): the body
        is forwarded VERBATIM and the reply's ``(status, body)`` handed
        back unparsed — no JSON round-trip on the proxy path."""
        return self._request("POST", path, body=body,
                             headers=extra_headers, timeout_s=timeout_s)

    def submit(self, session: str, obs, *,
               deadline_ms: float | None = None,
               timeout_s: float | None = None) -> dict:
        """One inference over the wire; returns the result dict or raises
        the reconstructed serving exception (see module table). The HTTP
        read timeout defaults to the deadline plus slack — a deadline'd
        request should die ENGINE-side (504), the transport timeout is
        only the backstop for a wedged peer."""
        payload = json.dumps(
            {"session": session,
             "obs": [float(x) for x in obs]}).encode()
        headers = {"Content-Type": "application/json"}
        if deadline_ms:
            headers[DEADLINE_HEADER] = f"{float(deadline_ms):g}"
            if timeout_s is None:
                timeout_s = max(float(deadline_ms) / 1e3 * 4, 5.0)
        status, body = self._request("POST", SUBMIT_PATH, body=payload,
                                     headers=headers, timeout_s=timeout_s)
        parsed = self._json(body)
        if status == STATUS_OK:
            return parsed
        raise status_to_error(status, parsed)

    def health(self, *, timeout_s: float | None = None) -> dict:
        status, body = self._request("GET", HEALTH_PATH,
                                     timeout_s=timeout_s)
        if status != STATUS_OK:
            raise ServeEngineFailed(f"healthz returned {status}")
        return self._json(body)

    def metrics(self, *, timeout_s: float | None = None) -> str:
        status, body = self._request("GET", METRICS_PATH,
                                     timeout_s=timeout_s)
        if status != STATUS_OK:
            raise ServeEngineFailed(f"metrics returned {status}")
        return body.decode("utf-8", errors="replace")

    @staticmethod
    def _json(body: bytes) -> dict:
        try:
            parsed = json.loads(body.decode("utf-8"))
        except (ValueError, UnicodeDecodeError):
            return {}
        return parsed if isinstance(parsed, dict) else {}
