"""Run metrics registry.

A copy of the JAX package's ``utils/metrics.py`` (it imports no JAX; the
port keeps its own copy rather than importing the JAX package). The
training orchestrator records each chunk's metric row here and the hot
loop's ``pipeline_stalls_total`` and ``pipeline_queue_depth``.

The reference's only "metrics" are the final avg/std portfolio aggregations
(TrainerRouterActor.scala:89-94,148-151). This registry generalizes that:
thread-safe scalar series with snapshot reads, so the orchestrator can answer
status queries mid-run without stopping the device loop (the reference answers
GetAvg mid-run from trained workers, TrainerRouterActorSpec.scala:81-95).

Two kinds of values:

- **gauges** (``record``/``record_many``) — point-in-time series, each
  bounded by a per-series ring (``max_points``; soak runs can no longer grow
  the host heap without limit, short runs never reach the cap);
- **counters** (``inc``/``counters``) — monotonic totals (``restarts_total``,
  ``heals_total``, ...), the Prometheus-counter half of the obs exporter's
  output;
- **histograms** (``attach_histogram``/``histograms``) — fixed-bucket
  mergeable distributions (obs/hist.py) owned and observed by their
  producers (the serve engine's per-stage latencies, the orchestrator's
  chunk timings); the registry only registers them for export, so the
  per-sample hot path never takes the registry lock. Duck-typed (anything
  with ``snapshot()``) so this module needs no obs import.
"""

from __future__ import annotations

import math
import threading
import time
from collections import defaultdict, deque
from typing import Any

#: Default per-series ring size: far beyond any short run (a full
#: reference-shape episode samples ~30 rows), small enough that a week-long
#: soak holds megabytes, not the run's whole history, in memory.
DEFAULT_MAX_POINTS = 65536


class MetricsRegistry:
    def __init__(self, *, max_points: int | None = DEFAULT_MAX_POINTS) -> None:
        self._lock = threading.Lock()
        # None/0 = unbounded (the pre-cap behavior, opt-in via config).
        self._maxlen = int(max_points) if max_points else None
        self._series: dict[str, deque[tuple[float, float]]] = defaultdict(
            self._new_series)
        self._latest: dict[str, float] = {}
        self._counters: dict[str, float] = {}
        self._histograms: dict[str, Any] = {}

    def _new_series(self) -> deque:
        return deque(maxlen=self._maxlen)

    def record(self, name: str, value: float, *, ts: float | None = None) -> None:
        ts = time.time() if ts is None else ts
        value = float(value)
        with self._lock:
            self._series[name].append((ts, value))
            self._latest[name] = value

    def record_many(self, values: dict[str, float]) -> None:
        """Record a whole metrics row under ONE lock acquisition (the
        per-sample hot-loop write path: a lock round-trip per key showed up
        once rows grew to ~10 keys x K megachunk rows per sample)."""
        ts = time.time()
        with self._lock:
            for name, value in values.items():
                value = float(value)
                self._series[name].append((ts, value))
                self._latest[name] = value

    # ---- counters (monotonic) ----

    def inc(self, name: str, amount: float = 1.0) -> float:
        """Increment a monotonic counter; returns the new total."""
        with self._lock:
            total = self._counters.get(name, 0.0) + float(amount)
            self._counters[name] = total
            return total

    def counters(self) -> dict[str, float]:
        with self._lock:
            return dict(self._counters)

    # ---- histograms (obs/hist.py, duck-typed) ----

    def attach_histogram(self, name: str, hist: Any) -> Any:
        """Register a histogram for export under ``name`` (idempotent for
        the same object; re-attaching a DIFFERENT object replaces it — the
        supervised-rebuild path). The producer keeps the reference and
        observes into it directly, off the registry lock."""
        with self._lock:
            self._histograms[name] = hist
        return hist

    def histogram(self, name: str) -> Any | None:
        """The live attached histogram object (None when absent)."""
        with self._lock:
            return self._histograms.get(name)

    def histograms(self) -> dict[str, dict]:
        """{name: snapshot} over every attached histogram — the exporter's
        drain unit (snapshots are consistent copies; see obs/hist.py)."""
        with self._lock:
            items = list(self._histograms.items())
        return {name: h.snapshot() for name, h in items}

    # ---- reads ----

    def latest(self, name: str, default: float | None = None) -> float | None:
        with self._lock:
            return self._latest.get(name, default)

    def series(self, name: str) -> list[tuple[float, float]]:
        with self._lock:
            return list(self._series.get(name, ()))

    def snapshot(self) -> dict[str, float]:
        with self._lock:
            return dict(self._latest)

    def summary(self, name: str) -> dict[str, float]:
        """Mean/std/min/max/count over a series — the avg/std aggregation the
        reference computes over worker portfolios, generalized. (Over the
        RETAINED ring when the series has been capped.)"""
        values = [v for _, v in self.series(name)]
        if not values:
            return {"count": 0.0}
        n = len(values)
        mean = sum(values) / n
        var = sum((v - mean) ** 2 for v in values) / n
        return {
            "count": float(n),
            "mean": mean,
            "std": math.sqrt(var),
            "min": min(values),
            "max": max(values),
        }


def mean_std(values: Any) -> tuple[float, float]:
    """Population mean/std, matching the reference's aggregation
    (TrainerRouterActor.scala:148-151: variance = E[(x-mean)^2], std = sqrt)."""
    vals = [float(v) for v in values]
    if not vals:
        raise ValueError("mean_std of empty sequence")
    m = sum(vals) / len(vals)
    var = sum((v - m) ** 2 for v in vals) / len(vals)
    return m, math.sqrt(var)
