"""Selector-driven wire engine: the fleet's event-loop backend.

One thread, one ``selectors`` loop (epoll/kqueue via DefaultSelector),
thousands of keep-alive connections, ZERO threads per in-flight request
— no GIL convoy of blocking wire threads as in the threaded front-end. A
copy of the JAX package's ``fleet/evloop.py``, trace spans included. All
HTTP framing lives in the sans-IO fleet/proto.py; this module owns only
the I/O mechanics:

- :class:`EventLoop` — a minimal reactor: non-blocking sockets under a
  DefaultSelector, a socketpair waker for cross-thread ``post()``, and
  a heapq deadline wheel (``call_later``) for request budgets.
- :class:`EvloopFrontend` — same surface as the threaded front-end
  (``start``/``drain``/``stop``, ``host``/``port``, the wire status
  table) over the same two-method backend contract, plus two
  non-blocking dispatch modes: a backend with ``submit_async`` (the
  local :class:`~sharetrade_tpu_torch.fleet.frontend.EngineBackend`) parks
  the request on the engine's own completion callback; a backend with
  ``proxy_request`` (the router) runs the byte-level relay below. Any
  other backend's ``serve_request`` is called inline on the loop — fine
  for cheap/test backends, documented as loop-blocking.
- :class:`_RelayEngine` — the router's thin proxy hop as a state
  machine: per-endpoint keep-alive upstream pools, non-blocking
  connects, per-attempt deadline timers, the torn-keep-alive fresh
  retry, and migration-to-a-survivor — driving the exact bookkeeping
  helpers ``FleetRouter.proxy_request`` uses, so both backends share
  one definition of the relay semantics.

Backpressure: writes are optimistic (one ``send`` on the hot path);
leftovers buffer and register EVENT_WRITE, and a connection whose
outbound buffer passes the high-water mark stops reading until it
drains — a stalled client throttles only its own connection.

fleet-net-ok: this module is the fleet's network layer, evloop flavor —
lint check 14 allows its listener; lint check 15 holds it to the
non-blocking discipline (no sendall/settimeout/sleep, no per-connection
threads — the ONE loop-runner thread carries the evloop-block-ok mark).
"""

from __future__ import annotations

import errno
import json
import selectors
import socket
import threading
import time
from collections import deque
from heapq import heappop, heappush

from sharetrade_tpu_torch.fleet import proto, wire
from sharetrade_tpu_torch.fleet.router import UNROUTED_DETAIL
from sharetrade_tpu_torch.obs.exporter import render_prom_text
from sharetrade_tpu_torch.serve.engine import ServeEngineFailed
from sharetrade_tpu_torch.utils.logging import get_logger

log = get_logger("fleet.evloop")

_READ = selectors.EVENT_READ
_WRITE = selectors.EVENT_WRITE
_RECV_SIZE = 1 << 16
#: Pause reads on a connection once this many reply bytes are queued.
_HIGH_WATER = 1 << 18


class _Timer:
    """One deadline-wheel entry; ``cancel()`` is lazy (the heap entry
    stays, the callback is dropped)."""

    __slots__ = ("when", "fn")

    def cancel(self) -> None:
        self.fn = None


class EventLoop:
    """A minimal single-thread reactor. Everything except ``post`` and
    ``stop`` must run ON the loop thread (``call_later`` included — the
    timer heap is unlocked by design)."""

    def __init__(self) -> None:
        self._sel = selectors.DefaultSelector()
        r, w = socket.socketpair()
        r.setblocking(False)
        w.setblocking(False)
        self._waker_r, self._waker_w = r, w
        self._sel.register(r, _READ, self._drain_waker)
        self._pending: deque = deque()
        self._lock = threading.Lock()
        self._timers: list = []
        self._seq = 0
        self._running = False
        self.stopped = threading.Event()

    # -- cross-thread surface ------------------------------------------

    def post(self, fn) -> None:
        """Enqueue ``fn`` to run on the loop thread; safe from any
        thread (the engine's consumer callback, drain/stop callers)."""
        with self._lock:
            self._pending.append(fn)
        try:
            self._waker_w.send(b"\x00")
        except (BlockingIOError, OSError):
            pass    # waker pipe full (wakeup already pending) or closed

    def stop(self) -> None:
        def _halt() -> None:
            self._running = False
        self.post(_halt)

    # -- loop-thread surface -------------------------------------------

    def call_later(self, delay_s: float, fn) -> _Timer:
        timer = _Timer()
        timer.when = time.monotonic() + delay_s
        timer.fn = fn
        self._seq += 1
        heappush(self._timers, (timer.when, self._seq, timer))
        return timer

    def add(self, sock, mask: int, cb) -> None:
        self._sel.register(sock, mask, cb)

    def set_mask(self, sock, mask: int, cb) -> None:
        self._sel.modify(sock, mask, cb)

    def remove(self, sock) -> None:
        self._sel.unregister(sock)

    def run(self) -> None:
        self._running = True
        try:
            while self._running:
                timeout = None
                if self._timers:
                    timeout = max(0.0,
                                  self._timers[0][0] - time.monotonic())
                with self._lock:
                    if self._pending:
                        timeout = 0.0
                for key, mask in self._sel.select(timeout):
                    try:
                        key.data(mask)
                    except Exception:   # noqa: BLE001 — one connection's
                        log.exception("evloop handler failed")  # fault
                self._run_pending()
                self._run_timers()
        finally:
            self.stopped.set()

    def close(self) -> None:
        try:
            self._sel.close()
        except OSError:
            pass
        for sock in (self._waker_r, self._waker_w):
            try:
                sock.close()
            except OSError:
                pass

    def _drain_waker(self, mask: int) -> None:
        try:
            while self._waker_r.recv(4096):
                pass
        except (BlockingIOError, InterruptedError):
            pass

    def _run_pending(self) -> None:
        while True:
            with self._lock:
                if not self._pending:
                    return
                fn = self._pending.popleft()
            try:
                fn()
            except Exception:   # noqa: BLE001
                log.exception("evloop posted callback failed")

    def _run_timers(self) -> None:
        now = time.monotonic()
        while self._timers and self._timers[0][0] <= now:
            _, _, timer = heappop(self._timers)
            fn, timer.fn = timer.fn, None
            if fn is None:
                continue
            try:
                fn()
            except Exception:   # noqa: BLE001
                log.exception("evloop timer failed")


class _Conn:
    """One buffered non-blocking socket under the loop: optimistic
    writes, EVENT_WRITE on leftovers, read pause past high water."""

    def __init__(self, loop: EventLoop, sock) -> None:
        self.loop = loop
        self.sock = sock
        self.out = bytearray()
        self.closed = False
        self.close_after_flush = False
        self._mask = 0
        self._reads_paused = False

    def register(self, mask: int) -> None:
        self._mask = mask
        self.loop.add(self.sock, mask, self._on_event)

    def write(self, data: bytes) -> None:
        if self.closed:
            return
        if not self.out:
            try:
                n = self.sock.send(data)
            except (BlockingIOError, InterruptedError):
                n = 0
            except OSError as exc:
                self.on_error(exc)
                return
            if n < len(data):
                self.out += memoryview(data)[n:]
        else:
            self.out += data
        if len(self.out) > _HIGH_WATER and not self._reads_paused:
            self._reads_paused = True
            self.on_paused()
        if self.close_after_flush and not self.out:
            self.close()
            return
        self._sync_mask()

    def close(self) -> None:
        if self.closed:
            return
        self.closed = True
        try:
            self.loop.remove(self.sock)
        except (KeyError, ValueError, OSError):
            pass
        try:
            self.sock.close()
        except OSError:
            pass
        self.on_closed()

    def _sync_mask(self) -> None:
        if self.closed:
            return
        want = 0 if self._reads_paused else _READ
        if self.out:
            want |= _WRITE
        if want == 0:       # selectors refuse an empty mask; a fully
            want = _READ    # stalled conn still watches for EOF/reset
        if want != self._mask:
            self._mask = want
            self.loop.set_mask(self.sock, want, self._on_event)

    def _on_event(self, mask: int) -> None:
        if mask & _WRITE:
            self._on_writable()
        if not self.closed and mask & _READ:
            self._on_readable()

    def _on_writable(self) -> None:
        try:
            while self.out:
                n = self.sock.send(self.out)
                if n <= 0:
                    break
                del self.out[:n]
        except (BlockingIOError, InterruptedError):
            pass
        except OSError as exc:
            self.on_error(exc)
            return
        if not self.out:
            if self.close_after_flush:
                self.close()
                return
            self._reads_paused = False
        self._sync_mask()

    def _on_readable(self) -> None:
        try:
            while True:
                chunk = self.sock.recv(_RECV_SIZE)
                if not chunk:
                    self.on_eof()
                    return
                self.on_bytes(chunk)
                if (self.closed or self._reads_paused
                        or len(chunk) < _RECV_SIZE):
                    break
        except (BlockingIOError, InterruptedError):
            pass
        except OSError as exc:
            self.on_error(exc)
            return
        self._sync_mask()

    # subclass surface -------------------------------------------------

    def on_bytes(self, data: bytes) -> None:
        raise NotImplementedError

    def on_eof(self) -> None:
        self.close()

    def on_error(self, exc: OSError) -> None:
        self.close()

    def on_closed(self) -> None:
        pass

    def on_paused(self) -> None:
        """Reads just paused past high water (backpressure) — the
        False→True transition only, so subclasses can count pauses
        rather than bytes-over-water polls."""


class _ServerConn(_Conn):
    """One downstream (client-facing) connection: requests parse off
    the byte stream and process ONE AT A TIME per connection (pipelined
    requests queue — HTTP/1.1 responses must return in request order),
    while distinct connections progress concurrently."""

    def __init__(self, fe: "EvloopFrontend", sock) -> None:
        super().__init__(fe.loop, sock)
        self.fe = fe
        self.parser = proto.RequestParser()
        self.pending: deque = deque()
        self.busy = False
        self.tracked = False        # current request counts in-flight
        self.cur_keep_alive = True
        self.cur_tctx = None        # current request's trace context
        self._pumping = False

    def on_bytes(self, data: bytes) -> None:
        try:
            events = self.parser.feed(data)
        except proto.ProtocolError as exc:
            # Unrecoverable framing: one loud reply, then close — the
            # byte stream has no next-message boundary to resync on.
            body = json.dumps({"error": "bad_request",
                               "detail": exc.detail}).encode()
            self._reads_paused = True
            self.close_after_flush = True
            self.write(proto.render_response(exc.status, body,
                                             keep_alive=False))
            return
        if events:
            self.pending.extend(events)
            self.pump()

    def pump(self) -> None:
        if self._pumping:
            return              # re-entered from a synchronous reply
        self._pumping = True
        try:
            while (not self.busy and self.pending and not self.closed
                   and not self.close_after_flush):
                request = self.pending.popleft()
                self.busy = True
                self.cur_keep_alive = request.keep_alive
                self.fe.process(self, request)
        finally:
            self._pumping = False

    def on_paused(self) -> None:
        self.fe.note_backpressure()

    def on_closed(self) -> None:
        self.fe.conns.discard(self)
        self.fe.record_open_conns()
        if self.tracked:
            # The client hung up with its request still in flight: the
            # backend call completes into a dead conn, but the in-flight
            # count must not leak past it (drain would wedge).
            self.tracked = False
            self.fe.request_done()


class _EngineCall:
    """One request parked on the local engine's completion callback —
    the evloop replacement for a handler thread's ``handle.wait``."""

    __slots__ = ("fe", "conn", "handle", "timer", "timeout_s", "tctx",
                 "done")

    def __init__(self, fe: "EvloopFrontend", conn: _ServerConn,
                 timeout_s: float) -> None:
        self.fe = fe
        self.conn = conn
        self.handle = None
        self.timer = None
        self.timeout_s = timeout_s
        self.tctx = None
        self.done = False

    def signal(self) -> None:
        """The engine's completion callback — fires on the engine's
        consumer thread; hop back onto the loop."""
        self.fe.loop.post(self.finish)

    def finish(self) -> None:
        if self.done:
            return
        self.done = True
        if self.timer is not None:
            self.timer.cancel()
        if self.tctx is not None:
            # The async twin of serve_request's completion spans — on
            # the loop thread, but a bounded tuple append.
            self.fe.backend.trace_complete(self.tctx, self.handle)
        result = self.handle.result
        if result is None:
            error = self.handle.error
            if error is None:   # raced the budget timer's semantics
                error = ServeEngineFailed(
                    f"request did not complete within the front-end "
                    f"budget ({self.timeout_s:.1f}s)")
            self.fe.reply_error(self.conn, error)
            return
        self.fe.reply(self.conn, wire.STATUS_OK,
                      self.fe.backend.result_dict(result))

    def on_timeout(self) -> None:
        """The front-end budget: a wedged engine surfaces as a loud 503
        instead of an immortal parked request."""
        if self.done:
            return
        self.done = True
        self.fe.note_deadline_expiry()
        self.fe.reply_error(self.conn, ServeEngineFailed(
            f"request did not complete within the front-end budget "
            f"({self.timeout_s:.1f}s)"))


class EvloopFrontend:
    """Event-loop wire front-end — the threaded front-end's surface
    (module docstring) with no thread per connection or request."""

    def __init__(self, backend, registry, *, host: str = "127.0.0.1",
                 port: int = 0, tracer=None) -> None:
        self.backend = backend
        self.registry = registry
        #: Optional :class:`~sharetrade_tpu_torch.fleet.wire.WireTracer` —
        #: None (the default) means zero trace parsing and zero spans.
        self.tracer = tracer
        self.draining = False
        self.loop = EventLoop()
        # fleet-net-ok: the fleet's one listener, evloop flavor.
        lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        lsock.bind((host, port))
        lsock.listen(1024)
        lsock.setblocking(False)
        self._lsock = lsock
        self.host, self.port = lsock.getsockname()[:2]
        self.conns: set = set()
        self._inflight = 0
        self._drain_waiters: list = []
        self._thread: threading.Thread | None = None
        if getattr(backend, "proxy_request", None) is not None:
            # The router: its relay runs natively on the loop, driving
            # the same FleetRouter bookkeeping the blocking path uses.
            self._relay = _RelayEngine(self, backend)
        else:
            self._relay = None

    # -- lifecycle -----------------------------------------------------

    def start(self) -> "EvloopFrontend":
        # Selector internals land in /metrics: which parse
        # path is live, how many keep-alive conns are open, and the
        # counters note_backpressure/note_deadline_expiry bump — the
        # loop thread stops being a black box.
        self.registry.record(
            "fleet_proto_backend_native",
            1.0 if proto.proto_backend == "native" else 0.0)
        self.record_open_conns()
        self.loop.add(self._lsock, _READ, self._on_accept)
        # Every connection and request multiplexes onto this single
        # selector thread, never a thread per connection:
        # evloop-block-ok — the ONE loop-runner thread.
        self._thread = threading.Thread(target=self.loop.run,
                                        name="fleet-evloop", daemon=True)
        self._thread.start()
        log.info("evloop front-end listening on %s:%d",
                 self.host, self.port)
        return self

    def drain(self, timeout_s: float = 30.0) -> bool:
        """Stop accepting, finish in-flight requests; False on timeout.
        New requests on surviving keep-alive connections get the loud
        503 draining refusal, same as the threaded backend."""
        done = threading.Event()

        def _begin_drain() -> None:
            self.draining = True
            self._close_listener()
            self._drain_waiters.append(done)
            self._check_drained()

        if self._thread is None:
            _begin_drain()
            return True
        self.loop.post(_begin_drain)
        return done.wait(timeout_s)

    def stop(self, timeout_s: float = 10.0) -> None:
        if self._thread is None:
            self._close_listener()
            self.loop.close()
            return

        def _shutdown() -> None:
            self.draining = True
            self._close_listener()
            for conn in list(self.conns):
                conn.close()
            if self._relay is not None:
                self._relay.close_all()
            self.loop.stop()

        self.loop.post(_shutdown)
        if self.loop.stopped.wait(timeout_s):
            self.loop.close()
        self._thread.join(timeout_s)
        self._thread = None

    def _close_listener(self) -> None:
        if self._lsock is None:
            return
        try:
            self.loop.remove(self._lsock)
        except (KeyError, ValueError, OSError):
            pass
        try:
            self._lsock.close()
        except OSError:
            pass
        self._lsock = None

    def _on_accept(self, mask: int) -> None:
        while True:
            try:
                sock, _ = self._lsock.accept()
            except (BlockingIOError, InterruptedError):
                return
            except OSError:
                return          # listener closed under us (drain)
            sock.setblocking(False)
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            conn = _ServerConn(self, sock)
            self.conns.add(conn)
            self.record_open_conns()
            conn.register(_READ)

    # -- selector observability ----------------------------------------

    def record_open_conns(self) -> None:
        self.registry.record("fleet_evloop_open_conns",
                             float(len(self.conns)))

    def note_backpressure(self) -> None:
        self.registry.inc("fleet_evloop_backpressure_pauses_total")

    def note_deadline_expiry(self) -> None:
        self.registry.inc("fleet_evloop_deadline_expiries_total")

    # -- in-flight accounting (loop thread only) -----------------------

    def request_begin(self, conn: _ServerConn) -> None:
        self._inflight += 1
        conn.tracked = True

    def request_done(self) -> None:
        self._inflight -= 1
        self._check_drained()

    def _check_drained(self) -> None:
        if self.draining and self._inflight <= 0 and self._drain_waiters:
            for waiter in self._drain_waiters:
                waiter.set()
            del self._drain_waiters[:]

    # -- request processing --------------------------------------------

    def process(self, conn: _ServerConn, request: proto.Request) -> None:
        # The body is already consumed — the parser only emits complete
        # messages, so an early 404/503 can never poison the keep-alive.
        if request.method == "GET":
            self._do_get(conn, request)
            return
        if request.target != wire.SUBMIT_PATH:
            self.reply(conn, 404, {"error": "not_found"})
            return
        if self.draining:
            self.reply(conn, wire.STATUS_UNAVAILABLE,
                       {"error": "engine_failed",
                        "detail": "front-end is draining"})
            return
        self.request_begin(conn)
        tctx = (self.tracer.begin(request.headers)
                if self.tracer is not None else None)
        conn.cur_tctx = tctx
        deadline_raw = request.headers.get("x-deadline-ms")
        clock_raw = request.headers.get("x-session-clock")
        if self._relay is not None:
            # The relay re-derives the clock from the router's own
            # affinity table per hop — an inbound header is not trusted.
            self._relay.start(conn, request.body, deadline_raw, tctx)
        elif getattr(self.backend, "submit_async", None) is not None:
            self._dispatch_engine(conn, request.body, deadline_raw,
                                  clock_raw, tctx)
        else:
            self._dispatch_inline(conn, request.body, deadline_raw,
                                  clock_raw, tctx)

    def _do_get(self, conn: _ServerConn, request: proto.Request) -> None:
        if request.target == wire.HEALTH_PATH:
            try:
                body = self.backend.health()
            except Exception as exc:    # noqa: BLE001
                self.reply(conn, wire.STATUS_UNAVAILABLE,
                           {"ok": False, "detail": repr(exc)})
                return
            body["draining"] = self.draining
            self.reply(conn, wire.STATUS_OK, body)
        elif request.target == wire.METRICS_PATH:
            reg = self.registry
            text = render_prom_text(reg.snapshot(), reg.counters(),
                                    reg.histograms())
            self.reply(conn, wire.STATUS_OK, text.encode(),
                       content_type="text/plain; version=0.0.4")
        else:
            self.reply(conn, 404, {"error": "not_found"})

    def _parse_submit(self, conn: _ServerConn, raw: bytes,
                      deadline_raw: str | None,
                      clock_raw: str | None = None):
        """Shared JSON/deadline/clock validation for the non-proxy
        paths; None means the 400 already went out."""
        try:
            payload = json.loads(raw)
            session = payload["session"]
            obs = payload["obs"]
        except (ValueError, KeyError, TypeError) as exc:
            self.reply_error(conn, ValueError(
                f"malformed submit body: {exc!r}"), counted=False)
            return None
        deadline_ms = None
        if deadline_raw is not None:
            try:
                deadline_ms = float(deadline_raw)
            except ValueError:
                self.reply_error(conn, ValueError(
                    f"malformed {wire.DEADLINE_HEADER}: "
                    f"{deadline_raw!r}"), counted=False)
                return None
        clock = None
        if clock_raw is not None and getattr(self.backend, "wire_clocked",
                                             False):
            try:
                clock = int(clock_raw) or None
            except ValueError:
                self.reply_error(conn, ValueError(
                    f"malformed {wire.CLOCK_HEADER}: "
                    f"{clock_raw!r}"), counted=False)
                return None
        return session, obs, deadline_ms, clock

    def _dispatch_engine(self, conn: _ServerConn, raw: bytes,
                         deadline_raw: str | None,
                         clock_raw: str | None = None, tctx=None) -> None:
        parsed = self._parse_submit(conn, raw, deadline_raw, clock_raw)
        if parsed is None:
            return
        session, obs, deadline_ms, clock = parsed
        self.registry.inc("frontend_requests_total")
        timeout_s = (max(float(deadline_ms) / 1e3 * 4, 5.0)
                     if deadline_ms else self.backend.request_timeout_s)
        traced = (tctx is not None
                  and getattr(self.backend, "wire_traced", False))
        call = _EngineCall(self, conn, timeout_s)
        call.tctx = tctx if traced else None
        kwargs = {"clock": clock} if clock is not None else {}
        try:
            call.handle = (self.backend.submit_async(
                session, obs, deadline_ms, call.signal, tctx=tctx,
                **kwargs)
                if traced else self.backend.submit_async(
                    session, obs, deadline_ms, call.signal, **kwargs))
        except Exception as exc:    # noqa: BLE001 — every serving
            # outcome maps to a wire status; the loop never dies.
            self.reply_error(conn, exc)
            return
        call.timer = self.loop.call_later(timeout_s, call.on_timeout)

    def _dispatch_inline(self, conn: _ServerConn, raw: bytes,
                         deadline_raw: str | None,
                         clock_raw: str | None = None, tctx=None) -> None:
        parsed = self._parse_submit(conn, raw, deadline_raw, clock_raw)
        if parsed is None:
            return
        session, obs, deadline_ms, clock = parsed
        self.registry.inc("frontend_requests_total")
        traced = (tctx is not None
                  and getattr(self.backend, "wire_traced", False))
        kwargs = {"clock": clock} if clock is not None else {}
        try:
            result = (self.backend.serve_request(session, obs,
                                                 deadline_ms, tctx=tctx,
                                                 **kwargs)
                      if traced else
                      self.backend.serve_request(session, obs,
                                                 deadline_ms, **kwargs))
        except Exception as exc:    # noqa: BLE001
            self.reply_error(conn, exc)
            return
        self.reply(conn, wire.STATUS_OK, result)

    # -- replies -------------------------------------------------------

    def reply(self, conn: _ServerConn, status: int, body,
              content_type: str = "application/json") -> None:
        tctx, conn.cur_tctx = conn.cur_tctx, None
        if tctx is not None:
            # The hop span closes when the reply is handed to the conn
            # buffer — a bounded tuple append, never a dump.
            self.tracer.finish(tctx, "frontend", note=str(status))
        if conn.tracked:
            conn.tracked = False
            self.request_done()
        conn.busy = False
        if conn.closed:
            return              # client hung up mid-request
        payload = (body if isinstance(body, bytes)
                   else json.dumps(body).encode())
        conn.write(proto.render_response(status, payload, content_type))
        if not conn.cur_keep_alive:
            conn.close_after_flush = True
            if not conn.out:
                conn.close()
            return
        conn.pump()

    def reply_error(self, conn: _ServerConn, exc: BaseException, *,
                    counted: bool = True) -> None:
        status, body = wire.error_to_status(exc)
        if status == 500:
            log.error("front-end request failed internally: %r", exc)
        if counted:
            self.registry.inc("frontend_errors_total")
        self.reply(conn, status, body)


class _UpstreamConn(_Conn):
    """One keep-alive connection from the relay to an engine: at most
    one request in flight (matching the blocking FleetClient), pooled
    per endpoint between requests."""

    def __init__(self, relay: "_RelayEngine", sock,
                 endpoint: tuple) -> None:
        super().__init__(relay.fe.loop, sock)
        self.relay = relay
        self.endpoint = endpoint
        self.parser = proto.ResponseParser()
        self.call = None
        self.connecting = False

    def on_paused(self) -> None:
        self.relay.fe.note_backpressure()

    def bind(self, call: "_RelayCall") -> None:
        self.call = call

    def _on_event(self, mask: int) -> None:
        if self.connecting:
            err = self.sock.getsockopt(socket.SOL_SOCKET,
                                       socket.SO_ERROR)
            if err:
                self.fail(f"connect failed: "
                          f"{errno.errorcode.get(err, err)}")
                return
            self.connecting = False
            call, self._mask = self.call, _READ
            self.loop.set_mask(self.sock, _READ, self._on_event)
            if call is not None:
                call.on_connected(self)
            return
        super()._on_event(mask)

    def on_bytes(self, data: bytes) -> None:
        try:
            events = self.parser.feed(data)
        except proto.ProtocolError as exc:
            self.fail(f"malformed upstream response: {exc.detail}")
            return
        if not events:
            return
        call, self.call = self.call, None
        if call is None:
            # Unsolicited bytes on an idle pooled connection: the
            # engine violated request/response pairing — discard it.
            self.close()
            return
        if len(events) > 1 or self.parser.pending_bytes():
            self.close()        # over-delivery: never pool this stream
        else:
            self.relay.checkin(self)
        call.on_response(events[0])

    def on_eof(self) -> None:
        self.fail("connection closed mid-response")

    def on_error(self, exc: OSError) -> None:
        self.fail(repr(exc))

    def fail(self, why: str) -> None:
        call, self.call = self.call, None
        self.close()
        if call is not None:
            call.on_conn_failed(self, why)


class _RelayCall:
    """One client request traversing the relay: hop to a routed engine,
    ONE fresh-connection retry on a torn keep-alive (the FleetClient
    contract — a failure on a fresh connection is the peer's true
    state), then migration to a survivor on engine loss or 503.

    Trace spans (when the request carries context and the router has a
    span sink): one ``relay`` envelope for the whole traversal, plus one
    ``relay_attempt`` child PER upstream attempt — its note names why
    the attempt was made (``first`` / ``retry:<why>`` /
    ``migrate:<why>``) and its span id rides to the engine as
    ``X-Parent-Span``, so a SIGKILLed engine's eagerly-flushed
    ``engine_recv`` still parents under a span the surviving router
    journals. All emission is bounded tuple appends."""

    __slots__ = ("relay", "router", "conn", "session", "body",
                 "deadline_raw", "timeout_s", "tried", "migrated",
                 "engine_id", "endpoint", "up", "timer", "reused",
                 "fresh_retry_used", "done", "tctx", "relay_span", "t0",
                 "attempt_span", "attempt_t0", "next_note")

    def __init__(self, relay: "_RelayEngine", conn: _ServerConn,
                 session: str, body: bytes,
                 deadline_raw: str | None, tctx=None) -> None:
        self.relay = relay
        self.router = relay.router
        self.conn = conn
        self.session = session
        self.body = body
        self.deadline_raw = deadline_raw
        self.timeout_s = relay.router.relay_timeout_s(deadline_raw)
        self.tried: set = set()
        self.migrated = False
        self.engine_id = None
        self.up = None
        self.timer = None
        self.reused = False
        self.fresh_retry_used = False
        self.done = False
        spans = getattr(relay.router, "spans", None)
        self.tctx = tctx if spans is not None else None
        if self.tctx is not None:
            self.relay_span = spans.new_span_id()
            self.t0 = time.perf_counter()
        else:
            self.relay_span = ""
            self.t0 = 0.0
        self.attempt_span = ""
        self.attempt_t0 = 0.0
        self.next_note = "first"

    # -- trace spans ---------------------------------------------------

    def _begin_attempt(self) -> None:
        if self.tctx is None:
            return
        self.attempt_span = self.router.spans.new_span_id()
        self.attempt_t0 = time.perf_counter()

    def _end_attempt(self, outcome: str = "") -> None:
        if self.tctx is None or not self.attempt_span:
            return
        note = (f"{self.next_note} {outcome}".strip()
                if outcome else self.next_note)
        self.router.spans.span(
            self.tctx[0], self.attempt_span, self.relay_span,
            "relay_attempt", self.attempt_t0, time.perf_counter(), note)
        self.attempt_span = ""

    # -- hop lifecycle -------------------------------------------------

    def next_hop(self) -> None:
        choice = self.router._route(self.session, exclude=self.tried)
        if choice is None:
            self.router.note_unrouted()
            status, body = wire.error_to_status(
                ServeEngineFailed(UNROUTED_DETAIL))
            self.finish(status, json.dumps(body).encode())
            return
        self.engine_id, self.endpoint = choice
        self.router.note_sent(self.engine_id)
        self.reused = False
        self.fresh_retry_used = False
        self._begin_attempt()
        self._attempt()

    def _attempt(self) -> None:
        self._arm_timer()
        up = self.relay.checkout(self.endpoint)
        if up is not None:
            self.reused = True
            up.bind(self)
            self.up = up
            self._send(up)
        else:
            self.up = self.relay.connect(self.endpoint, self)

    def _send(self, up: _UpstreamConn) -> None:
        headers = {}
        if self.deadline_raw is not None:
            headers[wire.DEADLINE_HEADER] = self.deadline_raw
        clock = self.router.session_clock(self.session)
        if clock > 0:
            # The router-observed session clock rides every hop so an
            # adopting engine can validate a spill record's step stamp
            # (the same header the blocking proxy path sends).
            headers[wire.CLOCK_HEADER] = str(clock)
        if self.attempt_span:
            # This attempt's span id is the downstream parent — each
            # retry/migration hands the engine a fresh parent.
            headers[proto.TRACE_HEADER] = self.tctx[0]
            headers[proto.PARENT_HEADER] = self.attempt_span
        up.write(proto.render_request(
            "POST", wire.SUBMIT_PATH,
            f"{self.endpoint[0]}:{self.endpoint[1]}", self.body,
            headers=headers or None))

    def _arm_timer(self) -> None:
        if self.timer is not None:
            self.timer.cancel()
        self.timer = self.relay.fe.loop.call_later(self.timeout_s,
                                                   self.on_timeout)

    def _disarm_timer(self) -> None:
        if self.timer is not None:
            self.timer.cancel()
            self.timer = None

    # -- upstream events -----------------------------------------------

    def on_connected(self, up: _UpstreamConn) -> None:
        if self.done or up is not self.up:
            up.call = None      # stale attempt (we timed out and moved
            up.close()          # on): never send on it
            return
        self._send(up)

    def on_conn_failed(self, up, why: str) -> None:
        if self.done or up is not self.up:
            return              # a stale attempt's verdict, not ours
        self.up = None
        self._end_attempt(why)
        if self.reused and not self.fresh_retry_used:
            # Torn keep-alive (the engine restarted, an idle timeout):
            # ONE retry on a fresh connection to the SAME engine.
            self.fresh_retry_used = True
            self.reused = False
            self.next_note = f"retry:{why}"
            self._begin_attempt()
            self._arm_timer()
            self.up = self.relay.connect(self.endpoint, self)
            return
        self._engine_gone(why)

    def on_timeout(self) -> None:
        if self.done:
            return
        self.relay.fe.note_deadline_expiry()
        up, self.up = self.up, None
        if up is not None:
            up.call = None
            up.close()
        why = f"timeout after {self.timeout_s:.1f}s"
        self._end_attempt(why)
        # Mirror the blocking path: a per-attempt timeout is a
        # transport error — fresh retry if the conn was reused, else
        # this engine is gone.
        if self.reused and not self.fresh_retry_used:
            self.fresh_retry_used = True
            self.reused = False
            self.next_note = f"retry:{why}"
            self._begin_attempt()
            self._arm_timer()
            self.up = self.relay.connect(self.endpoint, self)
            return
        self._engine_gone(why)

    def on_response(self, response: proto.Response) -> None:
        if self.done:
            return
        self.up = None
        self.router.note_done(self.engine_id)
        if response.status == wire.STATUS_UNAVAILABLE:
            self._disarm_timer()
            self._end_attempt(f"status {response.status}")
            self.tried.add(self.engine_id)
            self.migrated = True
            self.next_note = f"migrate:status {response.status}"
            self.router.note_engine_gone(
                self.session, self.engine_id,
                f"status {response.status}")
            self.next_hop()
            return
        self._disarm_timer()
        self._end_attempt(f"status {response.status}")
        status, reply = self.router.finish_relay(
            self.session, self.engine_id, self.migrated,
            response.status, response.body)
        self.finish(status, reply)

    def _engine_gone(self, why: str) -> None:
        self._disarm_timer()
        self.router.note_done(self.engine_id)
        self.tried.add(self.engine_id)
        self.migrated = True
        self.next_note = f"migrate:{why}"
        self.router.note_engine_gone(self.session, self.engine_id, why)
        self.next_hop()

    def finish(self, status: int, reply: bytes) -> None:
        self.done = True
        self._disarm_timer()
        self._end_attempt(f"status {status}")
        if self.tctx is not None:
            tctx = self.tctx
            self.router.spans.span(
                tctx[0], self.relay_span, tctx[2] or tctx[1], "relay",
                self.t0, time.perf_counter(),
                "migrated" if self.migrated else "")
        self.relay.fe.reply(self.conn, status, reply)


class _RelayEngine:
    """The router's data path on the loop (class docstring above)."""

    def __init__(self, fe: EvloopFrontend, router) -> None:
        self.fe = fe
        self.router = router
        self._pools: dict = {}      # endpoint -> deque of idle conns

    def start(self, conn: _ServerConn, body: bytes,
              deadline_raw: str | None, tctx=None) -> None:
        self.router.registry.inc("fleet_requests_total")
        try:
            session = wire.extract_session(body)
        except ValueError as exc:
            self.fe.reply_error(conn, exc, counted=False)
            return
        _RelayCall(self, conn, session, body, deadline_raw,
                   tctx).next_hop()

    # -- connection pool -----------------------------------------------

    def checkout(self, endpoint: tuple) -> _UpstreamConn | None:
        pool = self._pools.get(endpoint)
        while pool:
            up = pool.pop()
            if not up.closed:
                return up
        return None

    def checkin(self, up: _UpstreamConn) -> None:
        if up.closed or up.parser.pending_bytes():
            up.close()
            return
        self._pools.setdefault(up.endpoint, deque()).append(up)

    def connect(self, endpoint: tuple,
                call: _RelayCall) -> _UpstreamConn:
        """Begin a non-blocking connect; the verdict arrives as
        ``call.on_connected`` / ``call.on_conn_failed`` — ALWAYS via the
        loop (a synchronous refusal is posted, never re-entered), so the
        caller can record the returned conn as its current attempt
        first."""
        # fleet-net-ok: outbound non-blocking connect, no listener.
        sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        sock.setblocking(False)
        up = _UpstreamConn(self, sock, endpoint)
        up.bind(call)
        try:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            rc = sock.connect_ex(endpoint)
        except OSError as exc:
            rc, why = -1, repr(exc)
        else:
            why = f"connect failed: {errno.errorcode.get(rc, rc)}"
        if rc not in (0, errno.EINPROGRESS, errno.EWOULDBLOCK,
                      errno.EALREADY):
            up.closed = True
            sock.close()
            self.fe.loop.post(lambda: call.on_conn_failed(up, why))
            return up
        up.connecting = True
        up.register(_WRITE)
        return up

    def close_all(self) -> None:
        for pool in self._pools.values():
            while pool:
                pool.pop().close()
        self._pools.clear()
