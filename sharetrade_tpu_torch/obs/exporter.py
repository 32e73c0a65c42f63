"""Metrics exporter: ``MetricsRegistry`` → JSONL history + Prometheus
textfile, and the strict reader of that exposition.

The counterpart of the JAX package's ``obs/exporter.py``, in its formats.
The registry holds everything in memory; :class:`MetricsExporter` makes
that state durable and scrapeable without adding anything to the hot loop:
a background thread drains ``registry.snapshot()`` / ``registry.counters()``
/ ``registry.histograms()`` every ``interval_s`` seconds into

- ``metrics.jsonl``: one append-only line per drain, skipped when nothing
  changed;
- ``metrics.prom``: a Prometheus textfile snapshot (gauges, counters and
  histograms in exposition format, atomically rewritten).

:func:`render_prom_text` is also the fleet front-end's live ``/metrics``
body, and :func:`parse_prom_text` the router's scrape-side reader.
Histograms export as the standard ``_bucket{le=...}`` / ``_sum`` /
``_count`` triple with cumulative bucket counts ending in ``le="+Inf"``,
with the JAX package's label text, so a router of either package merges
the other's histograms bucket for bucket. A crashed exporter write
degrades observability, never the run.
"""

from __future__ import annotations

import json
import os
import re
import threading
import time

from sharetrade_tpu_torch.utils.logging import get_logger
from sharetrade_tpu_torch.utils.metrics import MetricsRegistry

log = get_logger("obs.exporter")

_PROM_BAD = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(name: str, prefix: str) -> str:
    return f"{prefix}_{_PROM_BAD.sub('_', name)}"


def _le(bound: float) -> str:
    """Prometheus ``le`` label text for a bucket bound: shortest exact-ish
    decimal (%.12g keeps the full double precision of the log-spaced
    bounds, so two engines' exports carry identical label sets — the
    merge-key contract)."""
    return f"{bound:.12g}"


def render_prom_text(gauges: dict, counters: dict,
                     hists: dict | None = None, *,
                     prefix: str = "sharetrade") -> str:
    """The Prometheus exposition of a registry: the live ``/metrics`` body
    both fleet front-ends serve. ``hists`` maps name → ``Histogram.snapshot``
    dicts (obs/hist.py); buckets export cumulative with ``le`` labels
    ending in ``+Inf`` (the merge contract :func:`parse_prom_text` checks
    on the scrape side)."""
    lines = []
    for name, value in sorted(gauges.items()):
        pname = _prom_name(name, prefix)
        lines.append(f"# TYPE {pname} gauge")
        lines.append(f"{pname} {value}")
    for name, value in sorted(counters.items()):
        pname = _prom_name(name, prefix)
        lines.append(f"# TYPE {pname} counter")
        lines.append(f"{pname} {value}")
    for name, snap in sorted((hists or {}).items()):
        pname = _prom_name(name, prefix)
        lines.append(f"# TYPE {pname} histogram")
        cum = 0
        for bound, c in zip(snap["bounds"], snap["counts"]):
            cum += c
            lines.append(f'{pname}_bucket{{le="{_le(bound)}"}} {cum}')
        cum += snap["counts"][len(snap["bounds"])]
        lines.append(f'{pname}_bucket{{le="+Inf"}} {cum}')
        lines.append(f"{pname}_sum {snap['sum']}")
        lines.append(f"{pname}_count {snap['count']}")
    return "\n".join(lines) + ("\n" if lines else "")


class MetricsExporter:
    def __init__(self, registry: MetricsRegistry, run_dir: str, *,
                 interval_s: float = 2.0, prefix: str = "sharetrade"):
        self._registry = registry
        self._jsonl_path = os.path.join(run_dir, "metrics.jsonl")
        self._prom_path = os.path.join(run_dir, "metrics.prom")
        self._interval_s = max(0.05, float(interval_s))
        self._prefix = prefix
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._last: tuple[dict, dict] | None = None
        self._io_lock = threading.Lock()   # drain() callable off-thread too

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._run, name="obs-exporter", daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.wait(self._interval_s):
            try:
                self.drain()
            except Exception:   # exporter IO must never kill anything
                log.exception("metrics export failed; will retry")

    def drain(self) -> bool:
        """One export pass; returns True when something was written."""
        gauges = self._registry.snapshot()
        counters = self._registry.counters()
        hists = self._registry.histograms()
        with self._io_lock:
            if (gauges, counters, hists) == self._last:
                return False
            self._last = (gauges, counters, hists)
            record = {"ts": time.time(), "gauges": gauges,
                      "counters": counters}
            if hists:
                record["histograms"] = hists
            with open(self._jsonl_path, "a", encoding="utf-8") as f:
                f.write(json.dumps(record) + "\n")
            self._write_prom(gauges, counters, hists)
        return True

    def _write_prom(self, gauges: dict, counters: dict,
                    hists: dict | None = None) -> None:
        text = render_prom_text(gauges, counters, hists,
                                prefix=self._prefix)
        tmp = f"{self._prom_path}.tmp-{os.getpid()}"
        with open(tmp, "w", encoding="utf-8") as f:
            f.write(text)
        os.replace(tmp, self._prom_path)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
        try:
            self.drain()        # final snapshot always lands on disk
        except Exception:
            log.exception("final metrics export failed")


# ---- strict exposition reader -----------------------------------------

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>[^}]*)\})?\s+(?P<value>\S+)$")
_LABEL_RE = re.compile(r'^(?P<key>[a-zA-Z_][a-zA-Z0-9_]*)="(?P<val>[^"]*)"$')


class PromParseError(ValueError):
    """An exposition violated the format or a histogram invariant."""


def parse_prom_text(text: str) -> dict:
    """Strict parser of :func:`render_prom_text`'s exposition.

    Validates, line by line: every sample is ``name[{labels}] value`` with
    a legal metric name and float value; every sample's base name was
    declared by a preceding ``# TYPE`` line; histogram series carry the
    full ``_bucket``(cumulative, nondecreasing, ``le``-labeled, ending in
    ``+Inf``)/``_sum``/``_count`` triple with ``+Inf == _count``; counter
    values are non-negative. Raises :class:`PromParseError` on any
    violation; returns ``{"gauges", "counters", "histograms"}`` where each
    histogram is ``{"buckets": [(le, cumulative)], "sum", "count"}``.
    """
    types: dict[str, str] = {}
    gauges: dict[str, float] = {}
    counters: dict[str, float] = {}
    hists: dict[str, dict] = {}

    def base_of(name: str) -> str:
        for suffix in ("_bucket", "_sum", "_count"):
            if name.endswith(suffix) and name[:-len(suffix)] in types:
                return name[:-len(suffix)]
        return name

    for ln, raw in enumerate(text.splitlines(), 1):
        line = raw.strip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split()
            if len(parts) >= 2 and parts[1] == "TYPE":
                if len(parts) != 4 or parts[3] not in (
                        "gauge", "counter", "histogram", "summary",
                        "untyped"):
                    raise PromParseError(f"line {ln}: malformed TYPE: {raw!r}")
                if not _NAME_RE.match(parts[2]):
                    raise PromParseError(
                        f"line {ln}: illegal metric name {parts[2]!r}")
                if parts[2] in types:
                    raise PromParseError(
                        f"line {ln}: duplicate TYPE for {parts[2]!r}")
                types[parts[2]] = parts[3]
            continue            # other comments / HELP: legal, ignored
        m = _SAMPLE_RE.match(line)
        if not m:
            raise PromParseError(f"line {ln}: malformed sample: {raw!r}")
        name = m.group("name")
        try:
            value = float(m.group("value"))
        except ValueError as exc:
            raise PromParseError(
                f"line {ln}: non-float value {m.group('value')!r}") from exc
        labels: dict[str, str] = {}
        if m.group("labels") is not None:
            for part in filter(None, m.group("labels").split(",")):
                lm = _LABEL_RE.match(part.strip())
                if not lm:
                    raise PromParseError(
                        f"line {ln}: malformed label {part!r}")
                labels[lm.group("key")] = lm.group("val")
        base = base_of(name)
        kind = types.get(base)
        if kind is None:
            raise PromParseError(
                f"line {ln}: sample {name!r} has no preceding TYPE")
        if kind == "gauge":
            gauges[name] = value
        elif kind == "counter":
            if value < 0:
                raise PromParseError(
                    f"line {ln}: negative counter {name}={value}")
            counters[name] = value
        elif kind == "histogram":
            h = hists.setdefault(base, {"buckets": [], "sum": None,
                                        "count": None})
            if name == f"{base}_bucket":
                le = labels.get("le")
                if le is None:
                    raise PromParseError(
                        f"line {ln}: histogram bucket without le label")
                if le != "+Inf":
                    try:
                        float(le)
                    except ValueError as exc:
                        raise PromParseError(
                            f"line {ln}: non-float le {le!r}") from exc
                if value != int(value) or value < 0:
                    raise PromParseError(
                        f"line {ln}: bucket count {value} is not a "
                        "non-negative integer")
                if h["buckets"] and value < h["buckets"][-1][1]:
                    raise PromParseError(
                        f"line {ln}: bucket counts not cumulative at "
                        f"le={le}")
                h["buckets"].append((le, int(value)))
            elif name == f"{base}_sum":
                h["sum"] = value
            elif name == f"{base}_count":
                h["count"] = value
            else:
                raise PromParseError(
                    f"line {ln}: unexpected histogram sample {name!r}")
        else:
            raise PromParseError(
                f"line {ln}: unsupported TYPE {kind!r} emitted by this "
                "exporter")
    for base, h in hists.items():
        if not h["buckets"] or h["buckets"][-1][0] != "+Inf":
            raise PromParseError(
                f"histogram {base!r} missing its +Inf bucket")
        if h["sum"] is None or h["count"] is None:
            raise PromParseError(
                f"histogram {base!r} missing _sum/_count")
        if h["buckets"][-1][1] != h["count"]:
            raise PromParseError(
                f"histogram {base!r}: +Inf bucket {h['buckets'][-1][1]} "
                f"!= _count {h['count']}")
    return {"gauges": gauges, "counters": counters, "histograms": hists}
