"""Telemetry of the port: the counterpart of the JAX package's ``obs/``,
in its file formats, so either package's ``cli obs`` reads the other's run
directories and either collector stitches the other's span journals.

Surfaces, all gated by ``ObsConfig`` (everything off by default: no
directory, no file):

- :mod:`trace`: the host span tracer → ``trace.jsonl`` (Chrome trace
  events; open in Perfetto / chrome://tracing). Under
  ``runtime.async_pipeline`` the timeline splits across threads:
  ``dispatch`` spans stay on the dispatcher's tid while ``readback`` /
  ``host_process`` move to the consumer's, joined by ``queue_wait``
  (consumer starved) and ``pipeline_stall`` (dispatcher blocked on the
  bounded queue) spans. A ``dispatch`` span times the enqueue of a CUDA
  graph replay, not the device. Also the fleet's span journal and sink
  (``obs.span_dir``), which :mod:`collect` stitches across processes;
- :mod:`exporter`: the background drain of ``MetricsRegistry`` →
  ``metrics.jsonl`` + the Prometheus textfile ``metrics.prom``;
- :mod:`flight`: a bounded ring of recent chunk metrics / lifecycle / log
  events → the ``flight_recorder.json`` bundle on failure;
- :mod:`manifest`: the run's identity (``manifest.json``: config hash,
  backend and card, git rev, tuned knobs), written when obs is built;
- :mod:`hist` (the JAX bucket layout) and :mod:`tsdb` (the fleet's
  history ring);
- :mod:`roofline`: the readers of a ``roofline.json``; the capture itself
  (``obs.roofline``) is refused (ROADMAP item 13b).

The :class:`Obs` facade is what the orchestrator and the serve engine
hold; a disabled instance is inert (``span()`` hands back a shared null
context, ``record()`` returns at once). Span arguments and flight records
take host values only: enabling obs adds no device synchronisation.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Any

from sharetrade_tpu_torch.config import ConfigError
from sharetrade_tpu_torch.obs.exporter import (  # noqa: F401
    MetricsExporter,
    PromParseError,
    parse_prom_text,
)
from sharetrade_tpu_torch.obs.flight import (  # noqa: F401
    FlightRecorder,
    RingLogHandler,
)
from sharetrade_tpu_torch.obs.hist import (  # noqa: F401
    Histogram,
    quantile_from_snapshot,
)
from sharetrade_tpu_torch.obs.manifest import (  # noqa: F401
    build_manifest,
    write_manifest,
)
from sharetrade_tpu_torch.obs.roofline import (  # noqa: F401
    read_roofline,
    summarize_roofline,
)
from sharetrade_tpu_torch.obs.trace import (  # noqa: F401
    SpanJournal,
    SpanSink,
    SpanTracer,
    new_trace_id,
    read_trace,
)

FLIGHT_BUNDLE = "flight_recorder.json"

#: Stage names of the serve request-latency decomposition, in lifecycle
#: order: the single source for the ``serve_<stage>_ms`` histogram
#: families of the engine, the ``cli serve`` summary and the run-dir
#: summary (the JAX names).
SERVE_STAGES = ("queue_wait", "batch_wait", "device", "readback")


def serve_stage_p99s(registry: Any) -> dict[str, float]:
    """Histogram-derived per-stage p99s off a live ``MetricsRegistry``:
    the "which stage owns the tail" row of the serve summary. Stages with
    no observations are omitted."""
    out: dict[str, float] = {}
    for stage in SERVE_STAGES:
        hist = registry.histogram(f"serve_{stage}_ms")
        if hist is not None and hist.count:
            out[stage] = round(hist.quantile(0.99), 3)
    return out


class Obs:
    """Facade over tracer / exporter / flight recorder for one run dir."""

    def __init__(self, *, run_dir: str | None = None,
                 tracer: SpanTracer | None = None,
                 exporter: MetricsExporter | None = None,
                 flight: FlightRecorder | None = None,
                 log_handler: RingLogHandler | None = None,
                 spans: SpanSink | None = None):
        self.run_dir = run_dir
        self.enabled = run_dir is not None
        self.tracer = tracer if tracer is not None else SpanTracer(None)
        #: Cross-process wire-span sink (obs.span_dir) — None when wire
        #: tracing is off; may be live even when ``enabled`` is False
        #: (fleet engine workers journal spans with the rest of obs off).
        self.spans = spans
        self.exporter = exporter
        # obs.flight_recorder=false means NO ring feeding and NO bundle —
        # the attribute stays a (never-dumped) recorder so attribute access
        # is uniform, but record()/dump_flight() gate on _flight_on.
        self._flight_on = self.enabled and flight is not None
        self.flight = flight if flight is not None else FlightRecorder(1)
        self._log_handler = log_handler
        self._closed = False

    # -- hot-loop surface ------------------------------------------------

    def span(self, name: str, **args: Any):
        return self.tracer.span(name, **args)

    def record(self, kind: str, **payload: Any) -> None:
        if self._flight_on:
            self.flight.record(kind, **payload)

    # -- failure path ----------------------------------------------------

    def dump_flight(self, *, reason: str, **context: Any) -> str | None:
        """Write the forensic bundle into the run dir; None when the flight
        recorder (or obs entirely) is disabled."""
        if not self._flight_on:
            return None
        path = os.path.join(self.run_dir, FLIGHT_BUNDLE)
        out = self.flight.dump(path, reason=reason, **context)
        self.tracer.instant("flight_recorder_dump", reason=reason)
        return out

    # -- lifecycle -------------------------------------------------------

    def flush(self) -> None:
        """Make everything durable without ending the run (terminal loop
        states flush; only Orchestrator.stop()/close() tear down)."""
        if self.spans is not None:
            self.spans.flush()
        if not self.enabled:
            return
        self.tracer.flush()
        if self.exporter is not None:
            try:
                self.exporter.drain()
            except Exception:
                pass            # export IO never outranks the run itself

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        if self.spans is not None:
            self.spans.close()
        if self.exporter is not None:
            self.exporter.stop()
        self.tracer.close()
        if self._log_handler is not None:
            logging.getLogger("sharetrade").removeHandler(self._log_handler)
            self._log_handler = None


def build_obs(cfg: Any, registry: Any, *, device: Any = None) -> Obs:
    """Construct the run's telemetry from ``cfg.obs``; inert when disabled
    (no directory is created, nothing is opened). ``device`` is the device
    the run targets, for the manifest. ``obs.roofline`` raises
    ``ConfigError`` (ROADMAP item 13b)."""
    oc = cfg.obs

    def _span_sink() -> SpanSink | None:
        # Wire-span journal: created iff obs.span_dir names a directory,
        # INDEPENDENT of oc.enabled, because fleet engine workers run
        # with obs off (telemetry stays with the fleet process) yet must
        # journal their half of every stitched trace.
        span_dir = getattr(oc, "span_dir", "")
        if not span_dir:
            return None
        proc = getattr(oc, "span_proc", "") or f"p{os.getpid()}"
        journal = SpanJournal(
            span_dir, proc,
            max_records=getattr(oc, "span_journal_records", 4096),
            max_segments=getattr(oc, "span_journal_segments", 8))
        return SpanSink(journal)

    if not oc.enabled:
        spans = _span_sink()
        return Obs(spans=spans) if spans is not None else Obs()
    if oc.roofline:
        raise ConfigError("obs.roofline=True is not yet ported to "
                          "sharetrade_tpu_torch (ROADMAP item 13b)")
    run_dir = oc.dir
    os.makedirs(run_dir, exist_ok=True)
    write_manifest(os.path.join(run_dir, "manifest.json"), cfg,
                   device=device)
    tracer = SpanTracer(os.path.join(run_dir, "trace.jsonl")
                        if oc.trace else None)
    exporter = None
    if oc.metrics_export:
        exporter = MetricsExporter(registry, run_dir,
                                   interval_s=oc.export_interval_s)
        exporter.start()
    flight = log_handler = None
    if oc.flight_recorder:
        flight = FlightRecorder(oc.flight_capacity)
        log_handler = RingLogHandler(flight)
        logging.getLogger("sharetrade").addHandler(log_handler)
    return Obs(run_dir=run_dir, tracer=tracer, exporter=exporter,
               flight=flight, log_handler=log_handler, spans=_span_sink())


def summarize_run_dir(run_dir: str) -> dict:
    """The ``cli obs`` summary: what a run dir contains, condensed to one
    JSON object (manifest identity, span aggregates, metrics tail, flight
    bundle verdict)."""
    out: dict[str, Any] = {"run_dir": run_dir}
    manifest_tuning = None
    manifest_path = os.path.join(run_dir, "manifest.json")
    if os.path.isfile(manifest_path):
        with open(manifest_path, encoding="utf-8") as f:
            m = json.load(f)
        out["manifest"] = {k: m.get(k) for k in (
            "config_hash", "backend", "device_count", "mesh_shape",
            "git_rev", "created_at")}
        manifest_tuning = m.get("tuning")
    if manifest_tuning:
        # Self-tuning provenance (tuning.py, stamped into the manifest):
        # the active profile + fingerprint and, per registered knob, the
        # resolved value vs its default and which tier won (explicit /
        # profile / default) — enriched below with the live controller
        # gauges when the run exported metrics.
        out["tuning"] = {
            "profile": manifest_tuning.get("profile"),
            "profile_error": manifest_tuning.get("profile_error"),
            "fingerprint": manifest_tuning.get("fingerprint"),
            "knobs": {
                path: {"value": info.get("value"),
                       "default": info.get("default"),
                       "source": info.get("source")}
                for path, info in sorted(
                    (manifest_tuning.get("knobs") or {}).items())},
        }
    trace_path = os.path.join(run_dir, "trace.jsonl")
    if os.path.isfile(trace_path):
        spans: dict[str, dict[str, float]] = {}
        for ev in read_trace(trace_path):
            if ev.get("ph") != "X":
                continue
            agg = spans.setdefault(ev["name"].split(":")[0],
                                   {"count": 0, "total_ms": 0.0})
            agg["count"] += 1
            agg["total_ms"] += ev.get("dur", 0.0) / 1e3
        out["trace"] = {
            name: {"count": int(a["count"]),
                   "total_ms": round(a["total_ms"], 3),
                   "mean_ms": round(a["total_ms"] / a["count"], 3)}
            for name, a in sorted(spans.items())}
    metrics_path = os.path.join(run_dir, "metrics.jsonl")
    if os.path.isfile(metrics_path):
        last = None
        drains = 0
        with open(metrics_path, encoding="utf-8") as f:
            for line in f:
                if line.strip():
                    drains += 1
                    last = line
        last_rec = json.loads(last) if last else None
        counters = (last_rec or {}).get("counters") or {}
        out["metrics"] = {
            "drains": drains,
            "last": last_rec,
            # Counter TOTALS surfaced at the top level of the summary (the
            # exporter's last drain is cumulative — counters are monotone),
            # with the pipeline-health number called out explicitly so an
            # operator doesn't have to know the registry key.
            "counters": counters,
            "pipeline_stalls_total": counters.get(
                "pipeline_stalls_total", 0.0),
            "prom_file": os.path.isfile(
                os.path.join(run_dir, "metrics.prom")),
        }
        gauges = (last_rec or {}).get("gauges") or {}
        hists = (last_rec or {}).get("histograms") or {}
        if hists:
            # Histogram tails in one glanceable block: per-metric count +
            # p50/p99 derived from the exported buckets (the same bucket
            # math a fleet aggregator runs after merging engines).
            out["histograms"] = {
                name: {"count": snap.get("count", 0),
                       "p50": round(quantile_from_snapshot(snap, 0.50), 3),
                       "p99": round(quantile_from_snapshot(snap, 0.99), 3)}
                for name, snap in sorted(hists.items())}
        if ("replay_size" in gauges
                or any(k.startswith(("per_", "journal_"))
                       for k in list(gauges) + list(counters))):
            # Replay data plane (journaled DQN runs): buffer fill, PER
            # priority/anneal state, and the bounded-journal segment
            # telemetry in one glanceable block.
            out["replay"] = {
                "replay_size": gauges.get("replay_size"),
                "per_max_priority": gauges.get("per_max_priority"),
                "per_beta": gauges.get("per_beta"),
                "journal_segments": gauges.get("journal_segments"),
                "journal_segments_retired_total": counters.get(
                    "journal_segments_retired_total", 0.0),
                "journal_compacted_bytes_total": counters.get(
                    "journal_compacted_bytes_total", 0.0),
            }
        if any(k.startswith(("actors_", "actor_", "distrib_"))
               for k in list(gauges) + list(counters)):
            # Actor/learner disaggregation (distrib/): pool membership,
            # supervision counters, per-actor ingest volume and heartbeat
            # ages in one glanceable block — the operator's "is the fleet
            # healthy and is the learner actually eating its output"
            # answer without knowing the registry keys.
            per_actor_rows = {
                k[len("actor_rows_ingested_total_"):]: v
                for k, v in counters.items()
                if k.startswith("actor_rows_ingested_total_")}
            heartbeat_ages = {
                k[len("actor_heartbeat_age_s_"):]: round(v, 3)
                for k, v in gauges.items()
                if k.startswith("actor_heartbeat_age_s_")}
            out["actors"] = {
                "alive": gauges.get("actors_alive"),
                "failed": gauges.get("actors_failed"),
                "backoff": gauges.get("actors_backoff"),
                "restarts_total": counters.get(
                    "actor_restarts_total", 0.0),
                "rows_ingested_total": counters.get(
                    "distrib_rows_ingested_total", 0.0),
                "feeds": gauges.get("distrib_actor_feeds"),
                "rows_ingested_by_actor": per_actor_rows,
                "heartbeat_age_s": heartbeat_ages,
            }
        if any(k.startswith("serve_") for k in list(gauges)
               + list(counters)):
            # Serving tier (``cli serve`` run dirs): the SLO surface in
            # one glanceable block — QPS, latency percentiles, batching
            # health — without the operator knowing the registry keys.
            out["serve"] = {
                "qps": gauges.get("serve_qps"),
                "p50_ms": gauges.get("serve_p50_ms"),
                "p99_ms": gauges.get("serve_p99_ms"),
                "batch_occupancy": gauges.get("serve_batch_occupancy"),
                "queue_depth": gauges.get("serve_queue_depth"),
                "requests_total": counters.get("serve_requests_total", 0.0),
                "batches_total": counters.get("serve_batches_total", 0.0),
                "prefills_total": counters.get("serve_prefills_total", 0.0),
                "evictions_total": counters.get(
                    "serve_evictions_total", 0.0),
                "swaps_total": counters.get("serve_swaps_total", 0.0),
                "swaps_rejected_total": counters.get(
                    "serve_swap_rejected_total", 0.0),
                # Overload & failure surface: shedding,
                # deadline expiry, supervised restarts, and the hot-swap
                # breaker in the same glanceable block.
                "overload": gauges.get("serve_overload"),
                "shed_total": counters.get("serve_shed_total", 0.0),
                "queue_rejected_total": counters.get(
                    "serve_queue_rejected_total", 0.0),
                "deadline_expired_total": counters.get(
                    "serve_deadline_expired_total", 0.0),
                "restarts_total": counters.get("serve_restarts_total", 0.0),
                "engine_failed": gauges.get("serve_failed"),
                "swap_breaker_open": gauges.get("serve_swap_breaker_open"),
                "swap_breaker_opens_total": counters.get(
                    "serve_swap_breaker_opens_total", 0.0),
                # Request-level observability: per-stage tail
                # decomposition, SLO burn rates, trace-health counters.
                "slo_availability_burn": gauges.get(
                    "serve_slo_availability_burn"),
                "slo_latency_burn": gauges.get("serve_slo_latency_burn"),
                "slo_burn_alerts_total": counters.get(
                    "serve_slo_burn_alerts_total", 0.0),
                "trace_decomposition_errors_total": counters.get(
                    "serve_trace_decomposition_error_total", 0.0),
            }
            stages = {}
            for stage in SERVE_STAGES:
                snap = hists.get(f"serve_{stage}_ms")
                if snap and snap.get("count"):
                    stages[stage] = {
                        "count": snap["count"],
                        "p50_ms": round(
                            quantile_from_snapshot(snap, 0.50), 3),
                        "p99_ms": round(
                            quantile_from_snapshot(snap, 0.99), 3)}
            if stages:
                out["serve"]["stages"] = stages
        if any(k.startswith(("serve_sessions_", "serve_warm_"))
               for k in list(gauges) + list(counters)):
            # Session tiers: the hot/warm/cold population and
            # the paging economics in one glanceable block — how many
            # sessions ride device slots vs the host-RAM warm tier, the
            # warm hit rate (a warm hit skips a cold re-prefill), bytes
            # held vs budget, and the live ms-saved-per-MB gauge that
            # answers "is the warm tier paying for its RAM".
            hits = counters.get("serve_warm_hits_total", 0.0)
            misses = counters.get("serve_warm_misses_total", 0.0)
            lookups = hits + misses
            out["sessions"] = {
                "hot": gauges.get("serve_sessions_hot"),
                "warm": gauges.get("serve_warm_sessions"),
                "warm_bytes": gauges.get("serve_warm_bytes"),
                "warm_budget_bytes": gauges.get(
                    "serve_warm_budget_bytes"),
                "warm_parks_total": counters.get(
                    "serve_warm_parks_total", 0.0),
                "warm_hits_total": hits,
                "warm_misses_total": misses,
                "warm_hit_rate": (round(hits / lookups, 4)
                                  if lookups else None),
                "warm_demotions_total": counters.get(
                    "serve_warm_demotions_total", 0.0),
                "warm_stale_drops_total": counters.get(
                    "serve_warm_stale_drops_total", 0.0),
                # Cold tier = sessions resumable only through the
                # journal re-prefill path (serve_prefills_total counts
                # every cold entry, first-time or paged back in).
                "cold_prefills_total": counters.get(
                    "serve_prefills_total", 0.0),
                "econ_ms_per_mb": gauges.get(
                    "serve_warm_econ_ms_per_mb"),
            }
            if (gauges.get("serve_spill_budget_bytes")
                    or counters.get("serve_spill_puts_total")):
                # The 4th rung: the crash-consistent disk
                # arena under the warm tier — how many carries sit
                # spilled, the adoption split after a migration (warm =
                # step stamp matched, cold = stale/torn/CRC-bad record
                # demoted to prefill), and how often records were
                # refused/corrupt. econ_ms_per_mb above already prices
                # spill hits — an adoption re-enters through the warm
                # store, so its saved prefill lands in warm_hits_total.
                out["sessions"]["spill"] = {
                    "sessions": gauges.get("serve_spill_sessions"),
                    "bytes": gauges.get("serve_spill_bytes"),
                    "budget_bytes": gauges.get(
                        "serve_spill_budget_bytes"),
                    "puts_total": counters.get(
                        "serve_spill_puts_total", 0.0),
                    "put_refusals_total": counters.get(
                        "serve_spill_put_refusals_total", 0.0),
                    "hits_total": counters.get(
                        "serve_spill_hits_total", 0.0),
                    "misses_total": counters.get(
                        "serve_spill_misses_total", 0.0),
                    "stale_total": counters.get(
                        "serve_spill_stale_total", 0.0),
                    "corrupt_total": counters.get(
                        "serve_spill_corrupt_total", 0.0),
                    "adopt_warm_total": counters.get(
                        "serve_adopt_warm_total", 0.0),
                    "adopt_cold_total": counters.get(
                        "serve_adopt_cold_total", 0.0),
                }
        if (manifest_tuning
                or any(k.startswith(("serve_knob_", "serve_controller_",
                                     "ingest_"))
                       for k in list(gauges) + list(counters))):
            # Live self-tuning state: current knob values as
            # the controllers last set them, adjustment counters, and
            # the last objective reading — next to the provenance block
            # above so "what is it tuned to" and "who set it" read as
            # one section.
            tuning_out = out.setdefault("tuning", {})
            tuning_out["live"] = {
                "serve_batch_timeout_ms": gauges.get(
                    "serve_knob_batch_timeout_ms"),
                "serve_max_queue": gauges.get("serve_knob_max_queue"),
                "controller_adjustments_total": counters.get(
                    "serve_controller_adjustments_total", 0.0),
                "controller_target_p99_ms": gauges.get(
                    "serve_controller_target_p99_ms"),
                "controller_last_p99_ms": gauges.get(
                    "serve_controller_p99_ms"),
                "ingest_every_updates_current": gauges.get(
                    "ingest_every_updates_current"),
                "ingest_adjustments_total": counters.get(
                    "ingest_adjustments_total", 0.0),
            }
    fleet_path = os.path.join(run_dir, "fleet_status.json")
    if os.path.isfile(fleet_path):
        # Fleet serving tier (``cli fleet`` / fleet/router.py): the
        # router's atomically-rewritten status — per-engine membership +
        # routing telemetry, merged-histogram fleet quantiles, affinity
        # table size, swap-propagation lag — condensed the same way the
        # other sections are (no registry-key spelunking required).
        try:
            with open(fleet_path, encoding="utf-8") as f:
                fs = json.load(f)
        except (OSError, ValueError):
            fs = None
        if fs:
            pool = fs.get("pool") or {}
            telemetry = fs.get("telemetry") or {}
            fgauges = fs.get("gauges") or {}
            engines = {}
            for eid, e in (pool.get("engines") or {}).items():
                t = telemetry.get(eid) or {}
                engines[eid] = {
                    "state": e.get("state"), "pid": e.get("pid"),
                    "port": e.get("port"),
                    "restarts": e.get("restarts"),
                    "params_step": e.get("params_step"),
                    "queue_depth": e.get("queue_depth"),
                    "window_p99_ms": t.get("window_p99_ms"),
                }
            out["fleet"] = {
                "engines": engines,
                "alive": pool.get("alive"),
                "failed": pool.get("failed"),
                "restarts_total": pool.get("restarts_total"),
                "engines_live": (fs.get("router") or {}).get(
                    "engines_live"),
                "merged_p50_ms": fgauges.get("fleet_p50_ms"),
                "merged_p99_ms": fgauges.get("fleet_p99_ms"),
                "merged_request_ms": fs.get("fleet_request_ms"),
                "affinity_sessions": (fs.get("router") or {}).get(
                    "affinity_sessions"),
                "swap_lag_steps": fgauges.get("fleet_swap_lag_steps"),
                "slo_availability_burn": fgauges.get(
                    "fleet_slo_availability_burn"),
                # Spill-tier migration outcomes: fleet-wide
                # parked-on-disk footprint plus the warm-vs-cold
                # adoption split after engine deaths/drains.
                "spill_sessions": fgauges.get("fleet_spill_sessions"),
                "spill_bytes": fgauges.get("fleet_spill_bytes"),
                "adopt_warm_total": (fs.get("counters") or {}).get(
                    "fleet_adopt_warm_total", 0.0),
                "adopt_cold_total": (fs.get("counters") or {}).get(
                    "fleet_adopt_cold_total", 0.0),
                "counters": fs.get("counters"),
                # Selector-thread internals: which HTTP
                # parse path is live (native C vs Python), open
                # keep-alive connections, and the loop's backpressure
                # and deadline-wheel counters.
                "evloop": {
                    "proto_backend": (
                        "native"
                        if fgauges.get("fleet_proto_backend_native")
                        else "py"
                        if "fleet_proto_backend_native" in fgauges
                        else None),
                    "open_conns": fgauges.get("fleet_evloop_open_conns"),
                    "backpressure_pauses_total": (fs.get("counters")
                                                  or {}).get(
                        "fleet_evloop_backpressure_pauses_total", 0.0),
                    "deadline_expiries_total": (fs.get("counters")
                                                or {}).get(
                        "fleet_evloop_deadline_expiries_total", 0.0),
                },
            }
    autoscale_path = os.path.join(run_dir, "fleet_autoscale.json")
    if os.path.isfile(autoscale_path):
        # Fleet autoscaler (fleet/autoscale.py): the membership
        # control loop's atomically-rewritten state — current target vs
        # actual engines, the operator bounds, and the last applied
        # decision with its reason. Folded into the "sessions" section
        # so paging capacity and fleet capacity read as one story.
        try:
            with open(autoscale_path, encoding="utf-8") as f:
                a = json.load(f)
        except (OSError, ValueError):
            a = None
        if a:
            out.setdefault("sessions", {})["autoscaler"] = {
                "target": a.get("target"), "actual": a.get("actual"),
                "floor": a.get("floor"), "ceiling": a.get("ceiling"),
                "decisions": a.get("decisions"),
                "last_decision": a.get("last_decision"),
            }
    exemplars_path = os.path.join(run_dir, "serve_exemplars.json")
    if os.path.isfile(exemplars_path):
        with open(exemplars_path, encoding="utf-8") as f:
            ex = (json.load(f).get("exemplars") or [])[:5]
        if ex:
            # The K slowest requests with their stage breakdown — the
            # "why was the tail slow" answer without opening the trace.
            out.setdefault("serve", {})["slowest_exemplars"] = ex
    roofline = read_roofline(run_dir)
    if roofline is not None:
        out["roofline"] = summarize_roofline(roofline)
    flight_path = os.path.join(run_dir, FLIGHT_BUNDLE)
    if os.path.isfile(flight_path):
        with open(flight_path, encoding="utf-8") as f:
            bundle = json.load(f)
        out["flight_recorder"] = {
            "reason": bundle.get("reason"),
            "failing_chunk": bundle.get("failing_chunk"),
            "context": bundle.get("context"),
            "events": len(bundle.get("events", [])),
        }
    return out
