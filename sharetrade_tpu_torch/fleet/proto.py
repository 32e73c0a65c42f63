"""Sans-IO HTTP/1.1 protocol core for the fleet wire — bytes in, events
out, zero I/O.

A copy of the JAX package's ``fleet/proto.py``, so both packages frame the
wire byte for byte alike: the blocking :class:`~sharetrade_tpu_torch.fleet.
wire.FleetClient`, the threaded front-end and the event-loop front-end
(fleet/evloop.py) all feed raw socket bytes into the same parsers and render
replies through the same renderers. It never touches a socket, a file, a
thread or a clock: a parser is a pure state machine, so every framing rule
(torn reads at any byte boundary, pipelined requests, the Content-Length
contract, header-size limits) is testable byte by byte without a network.

Framing rules (the fleet dialect, deliberately smaller than RFC 9112):

- Requests and responses are framed by ``Content-Length`` only — no
  chunked transfer, no multipart. A request without the header has an
  empty body (GETs); a response without it is a protocol error, because on
  a keep-alive connection "read until close" framing is indistinct from a
  torn response.
- A header block larger than :data:`MAX_HEAD_BYTES` or a body larger than
  :data:`MAX_BODY_BYTES` is refused before buffering unboundedly.
- ``feed()`` may be handed any split of the byte stream — one byte at a
  time, a half request, three pipelined requests in one chunk — and returns
  the complete messages in arrival order; partial tail bytes stay buffered
  for the next feed.

A parser only emits a :class:`Request` once its full body has arrived, so
a server replying 404/503 early can never leave body bytes behind to
poison the next request on a keep-alive connection.

Backends: the JAX package also has a native rung (``native/wire.cc``, a
CPython extension); the port has not ported it. :func:`set_backend` keeps
the contract of an unbuilt checkout: ``"native"`` degrades to ``"py"`` with
one loud log line per process, :func:`native_available` is False and
:func:`native_load_error` says why.
"""

from __future__ import annotations

#: Refuse a request/status line + header block larger than this — a
#: peer streaming an unbounded head is attacking the buffer, not
#: speaking the fleet protocol.
MAX_HEAD_BYTES = 16384

#: Refuse a declared body larger than this (submit bodies are a few KB;
#: the largest legitimate payload on the wire is a /metrics scrape).
MAX_BODY_BYTES = 1 << 26

_CRLF2 = b"\r\n\r\n"

#: Distributed-tracing context headers — rendered and parsed through THIS
#: module only, so both wire backends and the client carry them
#: identically. ``X-Trace-Id`` names the request's whole journey;
#: ``X-Parent-Span`` is the SENDING hop's span id, which the receiving
#: hop parents its own spans under. Replies NEVER echo them (spans are
#: journaled, not returned), which is what keeps the two backends'
#: reply streams byte-identical with tracing on or off.
TRACE_HEADER = "X-Trace-Id"
PARENT_HEADER = "X-Parent-Span"

#: Characters a trace/span id may contain (hex ids, pid-prefixed
#: counter ids like ``1a2f.3c``). Anything else on the wire is ignored
#: rather than propagated — a hop must never relay an id it could not
#: have minted.
_ID_CHARS = frozenset("0123456789abcdefABCDEF.-")
_ID_MAX = 64


def _valid_id(value: str) -> bool:
    return 0 < len(value) <= _ID_MAX and not set(value) - _ID_CHARS


def trace_context(headers: dict) -> tuple[str, str] | None:
    """The inbound trace context of a PARSED message's header dict:
    ``(trace_id, parent_span)`` — or None when absent/malformed (a bad
    id is dropped, never relayed). ``parent_span`` may be ``""`` (a
    trace id minted by a hop with no span of its own)."""
    trace_id = headers.get("x-trace-id")
    if not trace_id or not _valid_id(trace_id):
        return None
    parent = headers.get("x-parent-span", "")
    if parent and not _valid_id(parent):
        parent = ""
    return trace_id, parent

#: Reason phrases for the statuses the fleet actually speaks (see the
#: wire.py status table) — anything else renders its bare code.
REASONS = {
    200: "OK",
    400: "Bad Request",
    404: "Not Found",
    429: "Too Many Requests",
    500: "Internal Server Error",
    503: "Service Unavailable",
    504: "Gateway Timeout",
}


class ProtocolError(Exception):
    """A framing violation. ``status`` is what a SERVER should answer
    (400 for everything a client can cause); a CLIENT treats any
    ProtocolError from a ResponseParser as transport-class — the
    keep-alive byte stream is unrecoverable either way."""

    def __init__(self, detail: str, *, status: int = 400):
        super().__init__(detail)
        self.status = int(status)
        self.detail = detail


class Request:
    """One complete parsed request: ``headers`` is a last-wins dict of
    lower-cased names; ``keep_alive`` already folds the HTTP-version /
    Connection-header rules."""

    __slots__ = ("method", "target", "headers", "body", "keep_alive")

    def __init__(self, method: str, target: str, headers: dict,
                 body: bytes, keep_alive: bool):
        self.method = method
        self.target = target
        self.headers = headers
        self.body = body
        self.keep_alive = keep_alive

    def __repr__(self) -> str:
        return (f"Request({self.method} {self.target}, "
                f"{len(self.body)}B, keep_alive={self.keep_alive})")


class Response:
    """One complete parsed response."""

    __slots__ = ("status", "headers", "body")

    def __init__(self, status: int, headers: dict, body: bytes):
        self.status = status
        self.headers = headers
        self.body = body

    def __repr__(self) -> str:
        return f"Response({self.status}, {len(self.body)}B)"


def content_length(value) -> int:
    """THE Content-Length validation — the parsers and the threaded
    front-end's body read both go through here, so 'what counts as a
    well-formed length' has exactly one definition."""
    if value is None:
        return 0
    try:
        n = int(str(value).strip())
    except ValueError:
        raise ProtocolError(f"malformed Content-Length {value!r}") \
            from None
    if n < 0:
        raise ProtocolError(f"negative Content-Length {value!r}")
    if n > MAX_BODY_BYTES:
        raise ProtocolError(
            f"declared body of {n} bytes exceeds the "
            f"{MAX_BODY_BYTES}-byte limit")
    return n


def _parse_headers(lines: list[bytes]) -> dict:
    headers: dict[str, str] = {}
    for line in lines:
        name, sep, value = line.partition(b":")
        if not sep or not name.strip():
            raise ProtocolError(f"malformed header line {line!r}")
        headers[name.strip().decode("latin-1").lower()] = \
            value.strip().decode("latin-1")
    return headers


class _Parser:
    """Shared incremental framing: buffer → head block → exactly
    Content-Length body bytes → one event; repeat (pipelining)."""

    def __init__(self) -> None:
        self._buf = bytearray()
        self._head = None           # parsed head awaiting its body
        self._need = 0              # body bytes still owed

    def pending_bytes(self) -> bool:
        """True if the parser holds buffered bytes of an incomplete (or
        not-yet-consumed) message — a reused connection handing these
        back to a pool must NOT, the stream is mid-message."""
        return bool(self._buf) or self._head is not None

    def feed(self, data: bytes) -> list:
        """Feed any slice of the byte stream; returns every message
        COMPLETED by it, in order. Raises :class:`ProtocolError` on a
        framing violation (the connection is then unrecoverable)."""
        self._buf += data
        out = []
        while True:
            event = self._next()
            if event is None:
                return out
            out.append(event)

    def _next(self):
        if self._head is None:
            idx = self._buf.find(_CRLF2)
            if idx < 0:
                if len(self._buf) > MAX_HEAD_BYTES:
                    raise ProtocolError(
                        f"header block exceeds {MAX_HEAD_BYTES} bytes")
                return None
            if idx > MAX_HEAD_BYTES:
                raise ProtocolError(
                    f"header block exceeds {MAX_HEAD_BYTES} bytes")
            head = bytes(self._buf[:idx])
            del self._buf[:idx + 4]
            self._head, self._need = self._parse_head(head)
        if len(self._buf) < self._need:
            return None
        body = bytes(self._buf[:self._need])
        del self._buf[:self._need]
        head, self._head = self._head, None
        return self._finish(head, body)

    # subclass surface ------------------------------------------------

    def _parse_head(self, head: bytes):
        raise NotImplementedError

    def _finish(self, head, body: bytes):
        raise NotImplementedError


class PyRequestParser(_Parser):
    """Server side: bytes from a client connection → :class:`Request`
    events. (Pure-Python rung; :data:`RequestParser` below points at
    whichever backend is live.)"""

    def _parse_head(self, head: bytes):
        lines = head.split(b"\r\n")
        parts = lines[0].split()
        if len(parts) != 3:
            raise ProtocolError(f"malformed request line {lines[0]!r}")
        method, target, version = parts
        if not version.startswith(b"HTTP/1."):
            raise ProtocolError(f"unsupported version {version!r}")
        headers = _parse_headers(lines[1:])
        connection = headers.get("connection", "").lower()
        if version == b"HTTP/1.0":
            keep_alive = connection == "keep-alive"
        else:
            keep_alive = connection != "close"
        meta = (method.decode("latin-1"), target.decode("latin-1"),
                headers, keep_alive)
        return meta, content_length(headers.get("content-length"))

    def _finish(self, head, body: bytes) -> Request:
        method, target, headers, keep_alive = head
        return Request(method, target, headers, body, keep_alive)


class PyResponseParser(_Parser):
    """Client side: bytes from a server connection → :class:`Response`
    events. A response MUST carry Content-Length (module docstring)."""

    def _parse_head(self, head: bytes):
        lines = head.split(b"\r\n")
        parts = lines[0].split(None, 2)
        if len(parts) < 2 or not parts[0].startswith(b"HTTP/1."):
            raise ProtocolError(f"malformed status line {lines[0]!r}")
        try:
            status = int(parts[1])
        except ValueError:
            raise ProtocolError(
                f"malformed status line {lines[0]!r}") from None
        headers = _parse_headers(lines[1:])
        if "content-length" not in headers:
            raise ProtocolError(
                "response without Content-Length on a keep-alive "
                "connection")
        return (status, headers), content_length(headers["content-length"])

    def _finish(self, head, body: bytes) -> Response:
        status, headers = head
        return Response(status, headers, body)


# ---- rendering ------------------------------------------------------


def py_render_request(method: str, target: str, host: str,
                      body: bytes = b"",
                      headers: dict | None = None) -> bytes:
    """Build one request's wire bytes — the frame FleetClient sends (Host +
    Content-Length + extras, one buffer, ready for a single send)."""
    head = [f"{method} {target} HTTP/1.1",
            f"Host: {host}",
            f"Content-Length: {len(body)}"]
    for k, v in (headers or {}).items():
        head.append(f"{k}: {v}")
    return ("\r\n".join(head) + "\r\n\r\n").encode("latin-1") + body


def py_render_response(status: int, body: bytes,
                       content_type: str = "application/json", *,
                       keep_alive: bool = True,
                       extra_headers: dict | None = None) -> bytes:
    """Build one response's wire bytes. Both wire backends (threaded
    and evloop) render through here, which is what makes their reply
    streams byte-identical — the differential test's precondition."""
    head = [f"HTTP/1.1 {status} {REASONS.get(status, 'Unknown')}",
            f"Content-Type: {content_type}",
            f"Content-Length: {len(body)}"]
    if not keep_alive:
        head.append("Connection: close")
    for k, v in (extra_headers or {}).items():
        head.append(f"{k}: {v}")
    return ("\r\n".join(head) + "\r\n\r\n").encode("latin-1") + body


# ---- backend dispatch -----------------------------------------------
#
# Every wire party (the evloop, the threaded front-end, FleetClient)
# reaches the parsers and renderers through THESE module globals, so a
# backend swap swaps them for the whole process without any caller
# changing. Only the Python rung exists in the port.

#: Why the native rung is unavailable (the loud fallback line names it).
_NATIVE_ERROR = ("the native wire rung (native/wire.cc) is not ported to "
                 "sharetrade_tpu_torch (ROADMAP item 13)")
_FALLBACK_LOGGED = False

#: The backend that is LIVE right now (always "py" in the port).
proto_backend = "py"


def native_available() -> bool:
    """True when a native wire extension is loaded: never, in the port."""
    return False


def native_load_error() -> str:
    """Why :func:`native_available` is False."""
    return _NATIVE_ERROR


def set_backend(name: str) -> str:
    """Point the module-global parse/render surface at ``name`` ("native"
    or "py") and return what actually went live: "native" degrades to "py"
    with one loud log line per process."""
    global proto_backend, RequestParser, ResponseParser
    global render_request, render_response, _FALLBACK_LOGGED
    if name not in ("native", "py"):
        raise ValueError(
            f"unknown fleet.proto_backend {name!r} "
            "(expected 'native' or 'py')")
    if name == "native" and not _FALLBACK_LOGGED:
        import logging

        logging.getLogger("sharetrade.fleet.proto").warning(
            "native wire backend unavailable (%s) — falling back to the "
            "Python parser", _NATIVE_ERROR)
        _FALLBACK_LOGGED = True
    RequestParser = PyRequestParser
    ResponseParser = PyResponseParser
    render_request = py_render_request
    render_response = py_render_response
    proto_backend = "py"
    return "py"


#: Live parse/render surface — every wire party uses these names.
RequestParser = PyRequestParser
ResponseParser = PyResponseParser
render_request = py_render_request
render_response = py_render_response
