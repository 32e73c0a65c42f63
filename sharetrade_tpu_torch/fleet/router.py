"""Telemetry-driven request router over the engine fleet.

The router is a ``serve_request`` backend (fleet/frontend.py serves it on
the fleet's public port) that proxies each request to ONE engine worker,
chosen from the signals every engine already exports. A copy of the JAX
package's ``fleet/router.py``, relay spans included; a router of either
package fronts engines of the other:

- **routing score** (refreshed by the telemetry poller every
  ``fleet.telemetry_poll_s``): an engine's live queue depth plus a large
  penalty while its ``serve_overload`` gauge is up — new sessions land
  on the least-loaded live engine (round-robin tiebreak);
- **session affinity + clock**: a session sticks to the engine holding
  its slot-pool carry (LRU table bounded at
  ``fleet.affinity_max_sessions``) — the warm path. The affinity entry
  also carries the session's completed-response CLOCK, forwarded on
  every proxy hop as ``X-Session-Clock``: when the engine
  drains, dies, or deploys, the next request re-routes to a survivor,
  which ADOPTS the carry from the shared spill arena iff the record's
  step stamp matches that clock (``fleet_adopt_warm_total``) and
  re-enters cold through the batched prefill otherwise
  (``fleet_adopt_cold_total`` / ``fleet_migrations_total``) — a stale,
  torn, or CRC-bad record can cost latency, never bytes;
- **exact fleet quantiles**: the poller scrapes every engine's
  ``/metrics``, reconstructs the ``serve_request_ms`` histogram from its
  ``_bucket`` exposition (obs/hist.py ``from_prom_buckets`` — exact
  integer counts), and merges the per-window bucket DELTAS bucket-wise:
  ``fleet_p50_ms`` / ``fleet_p99_ms`` are computed on the merged
  histogram, NOT averaged per-engine percentiles (the percentile of a
  union is not a function of shard percentiles — the whole point of the
  shared bucket layout), plus a rolling fleet availability burn gauge
  from the engines' terminal-outcome counters;
- **degrade, never wedge**: a transport error mid-request drops the
  engine from the live set, drops the affinity, and retries the request
  ONCE PER SURVIVOR (inference is idempotent; a request in flight on a
  SIGKILLed engine completes on another instead of failing the client).
  With every engine terminal-failed/unreachable the router answers
  ``ServeEngineFailed`` → 503 loudly.

Deadline propagation: forwarded untouched in the ``X-Deadline-Ms``
header — expiry is the ENGINE's batch-collection gate, the router's
transport timeout is only the wedged-peer backstop.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import OrderedDict, deque
from typing import Any

from sharetrade_tpu_torch.fleet import proto, wire
from sharetrade_tpu_torch.fleet.wire import FleetClient
from sharetrade_tpu_torch.obs.exporter import parse_prom_text
from sharetrade_tpu_torch.obs.hist import (
    Histogram,
    from_prom_buckets,
    quantile_from_counts,
)
from sharetrade_tpu_torch.obs.tsdb import FLEET_HISTORY_FILE, TsdbRing
from sharetrade_tpu_torch.serve.engine import ServeEngineFailed
from sharetrade_tpu_torch.utils.logging import get_logger

log = get_logger("fleet.router")

STATUS_FILE = "fleet_status.json"
#: Bounded per-poll telemetry history (obs/tsdb.py) next to the status
#: file — the autoscaler's window.
HISTORY_FILE = FLEET_HISTORY_FILE

#: The total-outage refusal, word-for-word on both wire backends.
UNROUTED_DETAIL = ("no live engines: the whole fleet is failed, "
                   "draining, or unreachable")

#: Engine-side counters whose window deltas feed the fleet availability
#: burn (bad outcomes) and its denominator (all terminal outcomes).
_BAD_COUNTERS = ("serve_shed_total", "serve_queue_rejected_total",
                 "serve_deadline_expired_total")
_TOTAL_COUNTER = "serve_requests_total"

#: Engine-side spill/adoption counters folded (as window deltas) into
#: the same-named ``fleet_``-prefixed counters, exact against injected
#: kills.
_SPILL_COUNTERS = ("serve_adopt_warm_total", "serve_adopt_cold_total",
                   "serve_spill_hits_total", "serve_spill_misses_total",
                   "serve_spill_stale_total", "serve_spill_corrupt_total",
                   "serve_spill_puts_total")

#: Engine-side spill gauges summed fleet-wide each poll.
_SPILL_GAUGES = ("serve_spill_bytes", "serve_spill_sessions")


class _EngineView:
    """The router's live picture of one engine endpoint."""

    __slots__ = ("engine_id", "endpoint", "healthy", "health",
                 "queue_depth", "overload", "params_step",
                 "prev_counts", "prev_counters", "window_p99")

    def __init__(self, engine_id: str, endpoint: tuple[str, int]):
        self.engine_id = engine_id
        self.endpoint = endpoint
        self.healthy = False
        self.health: dict = {}
        self.queue_depth = 0.0
        self.overload = 0.0
        self.params_step = -1
        #: Cumulative serve_request_ms bucket counts at the last scrape
        #: (None until first seen; a restart resets them — detected by a
        #: shrinking count and re-based).
        self.prev_counts: list | None = None
        self.prev_counters: dict = {}
        self.window_p99: float | None = None


class FleetRouter:
    """See the module docstring. ``pool`` is anything with an
    ``endpoints() -> {engine_id: (host, port)}`` view — the supervising
    :class:`~sharetrade_tpu_torch.fleet.pool.EnginePool`, or a static
    ``StaticEndpoints`` for tests/external fleets."""

    #: Front-ends hand this backend the parsed wire trace context.
    wire_traced = True

    def __init__(self, pool: Any, cfg: Any, registry: Any, *,
                 workdir: str | None = None, obs_cfg: Any = None,
                 obs: Any = None):
        self.pool = pool
        self.cfg = cfg                      # FleetConfig
        self.registry = registry
        #: Status-file root; "" disables fleet_status.json entirely
        #: (in-process embedding and unit tests).
        self.dir = cfg.dir if workdir is None else (workdir or None)
        self._obs = obs
        #: The router's span sink (obs/trace.py SpanSink) — None means
        #: no relay spans, and inbound trace context is relayed but not
        #: journaled here.
        self.spans = getattr(obs, "spans", None)
        #: Per-poll gauge history ring; None without a workdir.
        self._history: TsdbRing | None = None
        history_rows = int(getattr(obs_cfg, "history_rows", 2048) or 0)
        if self.dir and history_rows > 0:
            os.makedirs(self.dir, exist_ok=True)
            self._history = TsdbRing(
                os.path.join(self.dir, HISTORY_FILE),
                max_rows=history_rows)
        #: Session → (engine_id | None, completed-response clock),
        #: LRU-bounded. The engine id is None while the session is
        #: between engines (its last engine died/drained) — the CLOCK
        #: must survive that gap, it is what lets the next engine
        #: validate a spill-arena record before adopting the carry.
        self._affinity: OrderedDict[str, tuple[str | None, int]] = \
            OrderedDict()
        self._aff_lock = threading.Lock()
        self._views: dict[str, _EngineView] = {}
        self._views_lock = threading.Lock()
        self._rr = 0                        # round-robin tiebreak
        #: LIVE per-engine outstanding relays (incremented around the
        #: proxy hop, under _views_lock): scraped queue depths go stale
        #: for a whole telemetry interval, and least-loaded routing on a
        #: stale signal sends every arrival in the window to the SAME
        #: "least loaded" engine — a thundering herd that convoys one
        #: engine while the rest idle (measured: worst-case p99 in the
        #: SECONDS under a session burst). The live count is the
        #: router's own ground truth between scrapes.
        self._outstanding: dict[str, int] = {}
        #: Per-handler-thread persistent connections, keyed by endpoint
        #: (an engine respawn changes the port, so stale conns die with
        #: their endpoint key instead of poisoning the new incarnation).
        self._tls = threading.local()
        #: Merged fleet histogram (cumulative across the fleet's whole
        #: life, kills included): bucket-wise sums of per-engine deltas.
        self._fleet_hist = self.registry.attach_histogram(
            "fleet_request_ms", Histogram())
        #: Rolling availability window: (t, cum_bad, cum_total) snapshots
        #: accumulated from engine counter deltas PLUS the router's own
        #: unrouted failures (during a total outage nothing scrapes, and
        #: the burn gauge must climb on router-side refusals alone).
        self._slo_cum_bad = 0.0
        self._slo_cum_total = 0.0
        self._prev_unrouted = 0.0
        # trace-buffer-ok: bounded ring of per-poll snapshots
        self._slo_win: deque[tuple] = deque(maxlen=4096)
        self._slo_win.append((time.monotonic(), 0.0, 0.0))
        slo_avail = float(getattr(obs_cfg, "slo_availability", 0.0)
                          or 0.0)
        slo_window = float(getattr(obs_cfg, "slo_window_s", 60.0) or 60.0)
        self._slo = (slo_avail, slo_window)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        if self.dir:
            os.makedirs(self.dir, exist_ok=True)

    # ---- lifecycle --------------------------------------------------

    def start(self) -> "FleetRouter":
        self._thread = threading.Thread(target=self._poll_loop,
                                        name="fleet-telemetry",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
        if self._history is not None:
            self._history.close()

    # ---- the serve_request backend (fleet/frontend.py) --------------

    def proxy_request(self, session: str, body: bytes,
                      deadline_raw: str | None,
                      tctx=None) -> tuple[int, bytes]:
        """The THIN data path (fleet/frontend.py's fast path): relay the
        raw request body to one engine and hand its ``(status, body)``
        back — no JSON parse/serialize on the proxy hop, which is what
        keeps the router cheaper per request than an engine (the whole
        premise of scale-out through one router). All routing semantics
        live here: affinity, telemetry scoring, and the migration retry
        — a transport error or a 503 (draining/terminally-failed engine)
        drops the engine from the live view and retries the request on a
        survivor; 429/504/4xx are a LIVE engine's true outcome and pass
        through untouched. The deadline header is forwarded VERBATIM —
        expiry belongs to the engine's collection gate.

        The routing/migration bookkeeping lives in the ``relay_*`` /
        ``note_*`` helpers below so the evloop relay (fleet/evloop.py)
        and this blocking loop share ONE definition of the semantics —
        what keeps the threaded backend an honest differential oracle
        for the event-loop one.

        When ``tctx`` (the front-end's parsed wire trace context)
        arrives and this router has a span sink, the traversal journals
        one ``relay`` envelope plus a ``relay_attempt`` per hop — each
        attempt's span id is forwarded as ``X-Parent-Span`` and its
        ``upstream_io`` child brackets the raw write/read — the same
        span shapes the evloop relay emits."""
        self.registry.inc("fleet_requests_total")
        headers: dict | None = ({wire.DEADLINE_HEADER: deadline_raw}
                                if deadline_raw is not None else None)
        clock = self.session_clock(session)
        if clock > 0:
            # The adoption contract's router half: the engine only pages
            # a spilled carry in when its step stamp matches this
            # completed-response count.
            headers = dict(headers or {})
            headers[wire.CLOCK_HEADER] = str(clock)
        timeout_s = self.relay_timeout_s(deadline_raw)
        tried: set[str] = set()
        migrated = False
        spans = self.spans
        if spans is None:
            tctx = None
        relay_span = spans.new_span_id() if tctx is not None else ""
        t0 = time.perf_counter()
        next_note = "first"
        while True:
            choice = self._route(session, exclude=tried)
            if choice is None:
                self.note_unrouted()
                if tctx is not None:
                    spans.span(tctx[0], relay_span, tctx[2] or tctx[1],
                               "relay", t0, time.perf_counter(),
                               "unrouted")
                raise ServeEngineFailed(UNROUTED_DETAIL)
            engine_id, endpoint = choice
            client = self._client_for(endpoint)
            self.note_sent(engine_id)
            hop_headers = headers
            attempt_span = io_span = ""
            attempt_t0 = 0.0
            if tctx is not None:
                attempt_span = spans.new_span_id()
                io_span = spans.new_span_id()
                attempt_t0 = time.perf_counter()
                hop_headers = dict(headers or {})
                hop_headers[proto.TRACE_HEADER] = tctx[0]
                hop_headers[proto.PARENT_HEADER] = attempt_span
            status, exc_repr = None, ""
            try:
                status, reply = client.raw_request(
                    wire.SUBMIT_PATH, body, extra_headers=hop_headers,
                    timeout_s=timeout_s)
            except wire.TRANSPORT_ERRORS as exc:
                status, reply, exc_repr = None, b"", repr(exc)
            finally:
                self.note_done(engine_id)
                if tctx is not None:
                    now = time.perf_counter()
                    why = (exc_repr if status is None
                           else f"status {status}")
                    spans.span(tctx[0], io_span, attempt_span,
                               "upstream_io", attempt_t0, now)
                    spans.span(tctx[0], attempt_span, relay_span,
                               "relay_attempt", attempt_t0, now,
                               f"{next_note} {why}".strip())
            if status is None or status == wire.STATUS_UNAVAILABLE:
                # The engine died/hung mid-request (SIGKILL chaos, a
                # deploy) — or answered 503 over a still-open keep-alive
                # because it is draining or terminally failed: either
                # way THIS ENGINE is gone, not the request. Drop it from
                # the live view NOW (the poller re-adds it when its
                # respawn answers), forget the session's affinity, and
                # retry on a survivor — the migration path.
                tried.add(engine_id)
                migrated = True
                why = exc_repr if status is None else f"status {status}"
                next_note = f"migrate:{why}"
                self.note_engine_gone(session, engine_id, why)
                continue
            if tctx is not None:
                spans.span(tctx[0], relay_span, tctx[2] or tctx[1],
                           "relay", t0, time.perf_counter(),
                           "migrated" if migrated else "")
            return self.finish_relay(session, engine_id, migrated,
                                     status, reply)

    def serve_request(self, session: str, obs,
                      deadline_ms: float | None, tctx=None) -> dict:
        """The in-process convenience surface (tests, embedding): the
        same routing path as :meth:`proxy_request`, with the JSON
        round-trip this caller asked for."""
        body = json.dumps({"session": session,
                           "obs": [float(x) for x in obs]}).encode()
        status, reply = self.proxy_request(
            session, body,
            f"{float(deadline_ms):g}" if deadline_ms else None,
            tctx=tctx)
        try:
            parsed = json.loads(reply.decode("utf-8"))
        except (ValueError, UnicodeDecodeError):
            parsed = {}
        if status == wire.STATUS_OK:
            return parsed
        raise wire.status_to_error(status, parsed)

    def health(self) -> dict:
        with self._views_lock:
            live = [v.engine_id for v in self._views.values()
                    if v.healthy]
            steps = sorted({v.params_step for v in self._views.values()
                            if v.healthy and v.params_step >= 0})
        with self._aff_lock:
            affinity = len(self._affinity)
        return {
            "ok": bool(live),
            "role": "router",
            "engines_live": len(live),
            "engines": live,
            "affinity_sessions": affinity,
            "params_steps": steps,
        }

    # ---- relay semantics (shared by both wire backends) --------------
    #
    # One hop of the data path, decomposed so the blocking loop above
    # and the evloop relay drive IDENTICAL bookkeeping: note_sent /
    # note_done bracket the hop (live outstanding), note_engine_gone is
    # the migration step, finish_relay the terminal accounting.

    def relay_timeout_s(self, deadline_raw: str | None) -> float:
        """Per-attempt transport timeout: the deadline plus slack when
        the client set one (expiry still belongs to the ENGINE — this
        is only the wedged-peer backstop), the configured front-end
        budget otherwise."""
        if deadline_raw is not None:
            try:
                return max(float(deadline_raw) / 1e3 * 4, 5.0)
            except ValueError:
                pass
        return self.cfg.request_timeout_s

    def note_sent(self, engine_id: str) -> None:
        with self._views_lock:
            self._outstanding[engine_id] = \
                self._outstanding.get(engine_id, 0) + 1

    def note_done(self, engine_id: str) -> None:
        with self._views_lock:
            n = self._outstanding.get(engine_id, 1) - 1
            if n > 0:
                self._outstanding[engine_id] = n
            else:
                self._outstanding.pop(engine_id, None)

    def note_engine_gone(self, session: str, engine_id: str,
                         why: str) -> None:
        """This ENGINE is gone, not the request: drop it from the live
        view (the poller re-adds it when its respawn answers), forget
        the session's affinity, and let the caller retry a survivor."""
        self._mark_unreachable(engine_id)
        self._drop_affinity(session)
        self.registry.inc("fleet_engine_errors_total")
        log.warning("engine %s gone mid-request (%s); re-routing "
                    "session %s", engine_id, why, session)

    def note_unrouted(self) -> None:
        self.registry.inc("fleet_unrouted_total")

    def finish_relay(self, session: str, engine_id: str, migrated: bool,
                     status: int, reply: bytes) -> tuple[int, bytes]:
        """Terminal accounting for a relayed reply: migration counter,
        affinity (the session clock ticks on a 200 — the router's half
        of the spill-adoption stamp contract), completion/refusal
        counters, and the engine-id splice into a 200's bytes (before
        the object's closing brace — naming the serving engine without
        a JSON round-trip)."""
        if migrated:
            self.registry.inc("fleet_migrations_total")
        self._note_affinity(session, engine_id,
                            bump=status == wire.STATUS_OK)
        if status == wire.STATUS_OK:
            self.registry.inc("fleet_completed_total")
            cut = reply.rfind(b"}")
            if cut >= 0:
                reply = (reply[:cut]
                         + f',"engine":"{engine_id}"'.encode()
                         + reply[cut:])
        else:
            # A live engine's protocol outcome (rejected / deadline /
            # bad request): the request's true terminal state, relayed
            # untouched, never retried by the router.
            self.registry.inc("fleet_refused_total")
        return status, reply

    # ---- routing ----------------------------------------------------

    def _route(self, session: str,
               exclude: set) -> tuple[str, tuple[str, int]] | None:
        endpoints = self.pool.endpoints()
        with self._views_lock:
            def usable(eid: str) -> bool:
                if eid in exclude or eid not in endpoints:
                    return False
                view = self._views.get(eid)
                # Before the first telemetry pass a listed endpoint is
                # given the benefit of the doubt (the submit path's
                # transport retry is the corrector).
                return view is None or view.healthy

            with self._aff_lock:
                entry = self._affinity.get(session)
            sticky = entry[0] if entry is not None else None
            if sticky is not None and usable(sticky):
                return sticky, endpoints[sticky]
            candidates = [eid for eid in endpoints if usable(eid)]
            if not candidates:
                return None
            def score(eid: str) -> float:
                view = self._views.get(eid)
                live = float(self._outstanding.get(eid, 0))
                if view is None:
                    return live
                return live + view.queue_depth + 1e6 * view.overload
            scored = [(score(eid), eid) for eid in candidates]
            best = min(s for s, _ in scored)
            pool = [eid for s, eid in scored if s == best]
            self._rr += 1
            chosen = pool[self._rr % len(pool)]
            return chosen, endpoints[chosen]

    def session_clock(self, session: str) -> int:
        """The session's completed-response count as this router has
        observed it (0 for an unknown session) — what the engine
        validates a spill record's step stamp against before adopting."""
        with self._aff_lock:
            entry = self._affinity.get(session)
        return entry[1] if entry is not None else 0

    def _note_affinity(self, session: str, engine_id: str, *,
                       bump: bool) -> None:
        with self._aff_lock:
            existing = self._affinity.pop(session, None)
            clock = existing[1] if existing is not None else 0
            # A 200 means the engine committed one more carry step for
            # this session — tick the clock; protocol refusals
            # (429/504/4xx) never touched the carry.
            self._affinity[session] = (engine_id, clock + 1 if bump
                                       else clock)
            while len(self._affinity) > self.cfg.affinity_max_sessions:
                self._affinity.popitem(last=False)

    def _drop_affinity(self, session: str) -> None:
        """Detach the session from its engine but KEEP its clock: the
        engine is gone, the session's history is not — the clock is the
        key that unlocks warm adoption from the spill arena."""
        with self._aff_lock:
            entry = self._affinity.get(session)
            if entry is not None:
                self._affinity[session] = (None, entry[1])

    def _drop_engine_affinity(self, engine_id: str) -> None:
        """Detach every session stuck to a dead engine (clock kept —
        see :meth:`_drop_affinity`) so the NEXT request of each
        re-routes without paying a transport error."""
        with self._aff_lock:
            for sid, (eid, clk) in list(self._affinity.items()):
                if eid == engine_id:
                    self._affinity[sid] = (None, clk)

    def _mark_unreachable(self, engine_id: str) -> None:
        with self._views_lock:
            view = self._views.get(engine_id)
            if view is not None:
                view.healthy = False
        self._drop_engine_affinity(engine_id)

    def _client_for(self, endpoint: tuple[str, int]) -> FleetClient:
        cache = getattr(self._tls, "clients", None)
        if cache is None:
            cache = self._tls.clients = {}
        client = cache.get(endpoint)
        if client is None:
            client = cache[endpoint] = FleetClient(
                endpoint[0], endpoint[1],
                timeout_s=self.cfg.request_timeout_s)
        return client

    # ---- telemetry poller -------------------------------------------

    def _poll_loop(self) -> None:
        interval = max(self.cfg.telemetry_poll_s, 0.05)
        while not self._stop.wait(interval):
            try:
                self.poll_once()
            except Exception:   # noqa: BLE001 — telemetry must outlive
                log.exception("fleet telemetry poll failed")

    def poll_once(self) -> None:
        """One telemetry pass (public: tests drive it
        deterministically): scrape every endpoint's healthz + metrics,
        refresh routing scores, merge histogram deltas, publish fleet
        gauges, rewrite fleet_status.json."""
        endpoints = self.pool.endpoints()
        scraped: dict[str, tuple[dict | None, dict | None]] = {}
        for engine_id, endpoint in endpoints.items():
            client = FleetClient(endpoint[0], endpoint[1],
                                 timeout_s=self.cfg.scrape_timeout_s)
            health = metrics = None
            try:
                health = client.health()
                metrics = parse_prom_text(client.metrics())
            except Exception:   # noqa: BLE001 — an unreachable engine is
                pass            # a datum (unhealthy), not a poller fault
            finally:
                client.close()
            scraped[engine_id] = (health, metrics)
        window_counts: list | None = None
        bounds = None
        window_bad = 0.0
        window_total = 0.0
        dead_engines = []
        spill_sums = {name: 0.0 for name in _SPILL_GAUGES}
        spill_seen = False
        with self._views_lock:
            for engine_id, endpoint in endpoints.items():
                view = self._views.get(engine_id)
                if view is None or view.endpoint != endpoint:
                    view = self._views[engine_id] = _EngineView(
                        engine_id, endpoint)
                health, metrics = scraped[engine_id]
                was_healthy = view.healthy
                view.healthy = bool(health) and not health.get(
                    "failed", False) and not health.get("draining", False)
                if health:
                    view.health = health
                    view.queue_depth = float(
                        health.get("queue_depth", 0) or 0)
                    view.overload = float(health.get("overload", 0) or 0)
                    view.params_step = int(
                        health.get("params_step", -1))
                if was_healthy and not view.healthy:
                    dead_engines.append(engine_id)
                if metrics:
                    w_counts, w_p99 = self._fold_engine_metrics(
                        view, metrics)
                    if w_counts is not None:
                        if window_counts is None:
                            window_counts = list(w_counts)
                            bounds = self._fleet_hist.bounds
                        else:
                            for i, c in enumerate(w_counts):
                                window_counts[i] += c
                    view.window_p99 = w_p99
                    bad, total = self._counter_deltas(view, metrics)
                    window_bad += bad
                    window_total += total
                    mg = metrics.get("gauges") or {}
                    for name in _SPILL_GAUGES:
                        v = mg.get(f"sharetrade_{name}")
                        if v is not None:
                            spill_seen = True
                            spill_sums[name] += float(v)
            # Engines the pool no longer lists (retired/failed corpses)
            # drop out of the view entirely.
            for gone in set(self._views) - set(endpoints):
                dead_engines.append(gone)
                del self._views[gone]
            live = sum(v.healthy for v in self._views.values())
            steps = [v.params_step for v in self._views.values()
                     if v.healthy and v.params_step >= 0]
            # Fleet-aggregate load signals, into the same gauge row the
            # history ring records — the autoscaler's (fleet/autoscale.
            # py) queue-pressure and overload inputs.
            agg_depth = sum(v.queue_depth
                            for v in self._views.values() if v.healthy)
            agg_overload = float(any(
                v.overload for v in self._views.values() if v.healthy))
        for engine_id in dead_engines:
            self._drop_engine_affinity(engine_id)
        # Router-level failures count against availability too: an
        # unrouted request never reached an engine counter, and a total
        # outage (no scrapes at all) must still burn the budget.
        unrouted = self.registry.counters().get("fleet_unrouted_total",
                                                0.0)
        d_unrouted = max(0.0, unrouted - self._prev_unrouted)
        self._prev_unrouted = unrouted
        window_bad += d_unrouted
        window_total += d_unrouted
        gauges: dict[str, float] = {
            "fleet_engines_live": float(live),
            "fleet_queue_depth": float(agg_depth),
            "fleet_overload": agg_overload,
        }
        if window_counts is not None and sum(window_counts) > 0:
            gauges["fleet_p50_ms"] = quantile_from_counts(
                bounds, window_counts, 0.50)
            gauges["fleet_p99_ms"] = quantile_from_counts(
                bounds, window_counts, 0.99)
        if steps:
            # Swap-propagation lag: how far the slowest live engine
            # trails the freshest published weights, in checkpoint steps.
            gauges["fleet_swap_lag_steps"] = float(max(steps) - min(steps))
        if spill_seen:
            # Fleet-wide spill-tier footprint: engines sharing one arena
            # each report the whole directory, so these sums over-count
            # by the sharing factor — they are a LOAD signal (how much
            # parked state a kill would put in play), not an exact
            # byte census; the counters above are the exact side.
            gauges["fleet_spill_bytes"] = spill_sums["serve_spill_bytes"]
            gauges["fleet_spill_sessions"] = \
                spill_sums["serve_spill_sessions"]
        with self._aff_lock:
            gauges["fleet_affinity_sessions"] = float(len(self._affinity))
        gauges.update(self._slo_burn(window_bad, window_total))
        self.registry.record_many(gauges)
        if self._history is not None:
            self._history.append({"ts": time.time(), **gauges})
        self._write_status(gauges)

    def _fold_engine_metrics(
            self, view: _EngineView,
            metrics: dict) -> tuple[list | None, float | None]:
        """Fold one engine's scraped ``serve_request_ms`` exposition:
        returns (window bucket-count delta, engine window p99). The
        delta is EXACT (integer cumulative subtraction); an engine
        restart (shrinking counts) re-bases at zero so a respawn's
        fresh histogram is not read as a negative window."""
        hist = (metrics.get("histograms") or {}).get(
            "sharetrade_serve_request_ms")
        if not hist:
            return None, None
        rebuilt = from_prom_buckets(hist["buckets"], hist["sum"],
                                    int(hist["count"]))
        counts = rebuilt.snapshot()["counts"]
        prev = view.prev_counts
        view.prev_counts = counts
        if prev is None or len(prev) != len(counts):
            prev = [0] * len(counts)
        delta = [a - b for a, b in zip(counts, prev)]
        if any(d < 0 for d in delta):
            # ANY negative bucket means the engine restarted between
            # scrapes (cumulative counts only grow within one life) —
            # a total-sum check misses a respawn that already out-served
            # its predecessor, and merging a negative bucket would
            # corrupt the fleet histogram permanently. Re-base: the
            # fresh incarnation's whole histogram IS the window.
            delta = list(counts)
        if sum(delta) <= 0:
            return delta, view.window_p99
        # Merge THIS window's per-engine delta into the cumulative fleet
        # histogram (bucket-wise integer add — exact).
        window = Histogram(bounds=rebuilt.bounds)
        window.counts = list(delta)
        window.count = sum(delta)
        self._fleet_hist.merge(window)
        p99 = rebuilt.quantile(0.99, counts=delta)
        return delta, p99

    def _counter_deltas(self, view: _EngineView,
                        metrics: dict) -> tuple[float, float]:
        counters = metrics.get("counters") or {}
        bad = total = 0.0
        cur: dict[str, float] = {}
        for name in _BAD_COUNTERS + (_TOTAL_COUNTER,) + _SPILL_COUNTERS:
            cur[name] = float(counters.get(f"sharetrade_{name}", 0.0))
        prev = view.prev_counters
        view.prev_counters = cur
        restarted = bool(prev) and cur.get(_TOTAL_COUNTER, 0) < prev.get(
            _TOTAL_COUNTER, 0)
        if prev and not restarted:
            for name in _BAD_COUNTERS:
                bad += max(0.0, cur[name] - prev.get(name, 0.0))
            total = max(0.0, cur[_TOTAL_COUNTER]
                        - prev.get(_TOTAL_COUNTER, 0.0))
        # Spill/adoption deltas fold into same-named fleet_ counters,
        # exact against injected kills. A restarted
        # engine's fresh counters ARE its window (rebase at zero); the
        # first scrape of a new engine folds everything since its boot.
        base = {} if restarted else (prev or {})
        for name in _SPILL_COUNTERS:
            d = cur[name] - base.get(name, 0.0)
            if d > 0:
                self.registry.inc("fleet_" + name[len("serve_"):], d)
        return bad, total

    def _slo_burn(self, window_bad: float,
                  window_total: float) -> dict[str, float]:
        """Fleet availability burn over the rolling ``obs.slo_window_s``:
        engine-counter deltas (sheds/rejections/expiries) plus the
        router's own unrouted failures, against the same objective the
        per-engine burn gauges use. Inert without an objective."""
        avail, window_s = self._slo
        if avail <= 0:
            return {}
        self._slo_cum_bad += window_bad
        self._slo_cum_total += window_total
        now = time.monotonic()
        win = self._slo_win
        win.append((now, self._slo_cum_bad, self._slo_cum_total))
        while len(win) > 1 and win[1][0] <= now - window_s:
            win.popleft()
        base = win[0]
        d_bad = self._slo_cum_bad - base[1]
        d_total = self._slo_cum_total - base[2]
        if d_total <= 0:
            return {}
        return {"fleet_slo_availability_burn":
                (d_bad / d_total) / (1.0 - avail)}

    # ---- status export ----------------------------------------------

    def _write_status(self, gauges: dict) -> None:
        if not self.dir:
            return
        status = {"ts": time.time(), "router": self.health()}
        pool_status = getattr(self.pool, "status", None)
        if callable(pool_status):
            status["pool"] = pool_status()
        with self._views_lock:
            status["telemetry"] = {
                v.engine_id: {
                    "healthy": v.healthy,
                    "queue_depth": v.queue_depth,
                    "overload": v.overload,
                    "params_step": v.params_step,
                    "window_p99_ms": v.window_p99,
                } for v in self._views.values()}
        status["gauges"] = {k: v for k, v in gauges.items()}
        # Selector internals: the front-end records these straight into
        # the shared registry (open keep-alive conns, live parse
        # backend) — fold the latest values in so the status file shows
        # the loop thread without scraping /metrics.
        for name, value in self.registry.snapshot().items():
            if (name.startswith("fleet_evloop_")
                    or name.startswith("fleet_proto_backend")):
                status["gauges"][name] = value
        status["counters"] = {
            k: v for k, v in self.registry.counters().items()
            if k.startswith("fleet_")}
        fleet_hist = self._fleet_hist.snapshot()
        status["fleet_request_ms"] = {
            "count": fleet_hist["count"],
            "p50_ms": self._fleet_hist.quantile(0.50),
            "p99_ms": self._fleet_hist.quantile(0.99),
        }
        path = os.path.join(self.dir, STATUS_FILE)
        tmp = f"{path}.tmp-{os.getpid()}"
        try:
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(status, f, indent=2)
            os.replace(tmp, path)
        except OSError:
            log.exception("fleet status write failed")


class StaticEndpoints:
    """A fixed endpoint set standing in for an :class:`EnginePool` —
    tests and externally-supervised fleets."""

    def __init__(self, endpoints: dict[str, tuple[str, int]]):
        self._endpoints = dict(endpoints)

    def endpoints(self) -> dict[str, tuple[str, int]]:
        return dict(self._endpoints)

    def set(self, endpoints: dict[str, tuple[str, int]]) -> None:
        self._endpoints = dict(endpoints)
