"""Telemetry of the port: the mergeable histograms (:mod:`hist`), the serve
stage names, the Prometheus renderer and its strict reader
(:mod:`exporter`, the fleet's ``/metrics``), the fleet's history ring
(:mod:`tsdb`) and trace ids (:mod:`trace`). The span tracer, the flight
recorder, the background metrics exporter and ``obs.enabled`` are not
ported; the engine's histograms and gauges live in its
``MetricsRegistry``."""

from __future__ import annotations

from typing import Any

#: Stage names of the serve request-latency decomposition, in lifecycle
#: order: the single source for the ``serve_<stage>_ms`` histogram
#: families of the engine and the ``cli serve`` summary (the JAX names).
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
