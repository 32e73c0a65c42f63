"""Mergeable streaming histograms with fixed log-spaced buckets.

The port's copy of the JAX package's ``obs/hist.py`` (numpy-free, pure
Python), with the same bucket layout, so a histogram from either package
merges exactly with one from the other. A fixed, name-determined bucket
layout shared by every process means:

- **merge is exact**: two shards' histograms combine by bucket-wise count
  addition (plus sum/count), with no approximation from the merge itself;
- **windows are subtraction**: cumulative counts snapshotted at t0 and t1
  diff into the exact histogram of the interval (how the serve engine
  derives its rolling p50/p99 gauges without a sample ring);
- **quantiles are bounded-error**: any quantile estimate is within ONE
  bucket width of the exact nearest-rank sample quantile
  (``serve/engine.py latency_percentiles``, the repo's single quantile
  convention).

Buckets are log-spaced (``per_decade`` bounds per power of 10) because
latencies live on a ratio scale: constant RELATIVE resolution from 10 µs
to minutes in ~35 buckets. The layout is part of a metric's contract:
``DEFAULT_MS_BOUNDS`` for every ``*_ms`` histogram, ``SECONDS_BOUNDS``
for ``*_seconds``, so independently started engines always merge.

Thread-safety: each histogram carries its own lock; ``observe`` is a
bisect + two adds under it (no allocation), cheap enough for per-request
hot paths. ``MetricsRegistry.attach_histogram`` registers one for export.
"""

from __future__ import annotations

import math
import threading
from bisect import bisect_left

__all__ = [
    "DEFAULT_MS_BOUNDS",
    "SECONDS_BOUNDS",
    "Histogram",
    "from_prom_buckets",
    "log_bounds",
    "merge",
    "quantile_from_counts",
    "quantile_from_snapshot",
]


def log_bounds(lo: float, hi: float, *, per_decade: int = 5
               ) -> tuple[float, ...]:
    """Log-spaced bucket upper bounds from ``lo`` up to (at least) ``hi``,
    ``per_decade`` per power of ten. Generated from integer exponents so
    two processes computing the same spec get BIT-IDENTICAL bounds — the
    precondition for exact merges."""
    if lo <= 0 or hi <= lo or per_decade < 1:
        raise ValueError(
            f"log_bounds needs 0 < lo < hi and per_decade >= 1, got "
            f"lo={lo} hi={hi} per_decade={per_decade}")
    e0 = round(math.log10(lo) * per_decade)
    bounds = []
    e = e0
    while True:
        b = 10.0 ** (e / per_decade)
        bounds.append(b)
        if b >= hi:
            return tuple(bounds)
        e += 1


#: The framework-wide layout for millisecond metrics (`*_ms`): 10 µs to
#: ~100 s at 5 buckets/decade (36 bounds). Changing this changes the merge
#: contract — bump only with a fleet-wide flag day.
DEFAULT_MS_BOUNDS = log_bounds(0.01, 1e5, per_decade=5)

#: Layout for second-scale training metrics (chunk wall times): 100 µs to
#: ~1000 s.
SECONDS_BOUNDS = log_bounds(1e-4, 1e3, per_decade=5)


def quantile_from_counts(bounds, counts, q: float) -> float:
    """Nearest-rank quantile estimate over NON-cumulative per-bucket
    ``counts`` (len(bounds) + 1, last = overflow). Matches the exact
    convention of ``serve/engine.py latency_percentiles`` (1-indexed rank
    ``ceil(q * n)``), then linearly interpolates inside the selected
    bucket — the estimate is within one bucket width of the exact sample
    quantile. Empty counts return 0.0; an overflow-bucket hit returns the
    top finite bound (the histogram cannot see past it)."""
    total = sum(counts)
    if total <= 0:
        return 0.0
    rank = min(max(math.ceil(q * total), 1), total)
    cum = 0
    for i, c in enumerate(counts):
        if not c:
            continue
        if cum + c >= rank:
            if i >= len(bounds):
                return float(bounds[-1])
            lo = bounds[i - 1] if i > 0 else 0.0
            hi = bounds[i]
            frac = (rank - cum) / c
            return float(lo + frac * (hi - lo))
        cum += c
    return float(bounds[-1])


def quantile_from_snapshot(snapshot: dict, q: float) -> float:
    """Quantile over a :meth:`Histogram.snapshot` dict (what the exporter
    writes into ``metrics.jsonl`` — the ``cli obs`` reader's entry point)."""
    return quantile_from_counts(snapshot["bounds"], snapshot["counts"], q)


class Histogram:
    """Fixed-bucket streaming histogram; see the module docstring.

    ``counts`` is NON-cumulative per bucket with one overflow slot at the
    end; the Prometheus cumulative form (including ``+Inf``) is derived at
    export time. ``sum``/``count`` ride along for ``_sum``/``_count``."""

    __slots__ = ("bounds", "counts", "sum", "count", "_lock")

    def __init__(self, bounds=None):
        bounds = tuple(bounds) if bounds is not None else DEFAULT_MS_BOUNDS
        if not bounds or any(b2 <= b1 for b1, b2 in zip(bounds, bounds[1:])):
            raise ValueError("histogram bounds must be strictly ascending "
                             "and non-empty")
        self.bounds = bounds
        self.counts = [0] * (len(bounds) + 1)
        self.sum = 0.0
        self.count = 0
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        """Count one sample (bucket semantics: ``value <= bound``, the
        Prometheus ``le`` convention)."""
        value = float(value)
        idx = bisect_left(self.bounds, value)
        with self._lock:
            self.counts[idx] += 1
            self.sum += value
            self.count += 1

    def merge(self, other: "Histogram") -> "Histogram":
        """Bucket-wise add ``other`` into self (EXACT — integer counts).
        Refuses mismatched layouts loudly: merging across different bucket
        specs would silently corrupt every downstream quantile."""
        if self.bounds != other.bounds:
            raise ValueError(
                "cannot merge histograms with different bucket bounds "
                f"({len(self.bounds)} vs {len(other.bounds)} buckets)")
        o = other.snapshot()
        with self._lock:
            for i, c in enumerate(o["counts"]):
                self.counts[i] += c
            self.sum += o["sum"]
            self.count += o["count"]
        return self

    def snapshot(self) -> dict:
        """Consistent copy: ``{"bounds", "counts", "sum", "count"}`` —
        the exporter/merge/window unit."""
        with self._lock:
            return {"bounds": list(self.bounds),
                    "counts": list(self.counts),
                    "sum": self.sum,
                    "count": self.count}

    def quantile(self, q: float, *, counts=None) -> float:
        """Quantile estimate (within one bucket width of exact). Pass
        ``counts`` (e.g. a window delta from two snapshots) to evaluate a
        sub-interval instead of the cumulative distribution."""
        if counts is None:
            counts = self.snapshot()["counts"]
        return quantile_from_counts(self.bounds, counts, q)


def merge(histograms) -> Histogram:
    """Fresh histogram holding the exact bucket-wise sum of ``histograms``
    (all must share one layout) — the fleet-aggregation helper."""
    hs = list(histograms)
    if not hs:
        raise ValueError("merge() of no histograms")
    out = Histogram(bounds=hs[0].bounds)
    for h in hs:
        out.merge(h)
    return out


def from_prom_buckets(buckets, total_sum: float, count: int) -> Histogram:
    """Rebuild a :class:`Histogram` from a scraped Prometheus exposition —
    ``buckets`` is the ``[(le, cumulative)]`` list a Prometheus text parser
    returns (``le`` = ``+inf`` for the
    overflow terminal). The reconstruction is EXACT: cumulative counts
    diff back to the per-bucket integers the engine observed, so a
    bucket-wise merge of scraped engines equals the merge of the
    engines' in-process histograms bit for bit.

    Raises ``ValueError`` on a non-monotone cumulative series, a missing
    ``+Inf`` terminal, or a ``+Inf``/count mismatch — a corrupt scrape
    must never silently fold garbage into fleet quantiles."""
    # parse_prom_text hands le through as label TEXT ("+Inf" included);
    # float() accepts both spellings, so scraped and in-process sources
    # meet here.
    buckets = [(float(le), cum) for le, cum in buckets]
    if not buckets or not math.isinf(buckets[-1][0]):
        raise ValueError("prom histogram must end in a +Inf bucket")
    bounds = tuple(le for le, _ in buckets[:-1])
    # The exporter's %.12g labels drop the last ~4 bits of a double, so
    # a parsed bound can differ from its source by ~1e-13 relative —
    # enough for Histogram.merge's layout check to refuse a scraped
    # shard against an in-process histogram. Snap to the canonical
    # framework layouts when the LABEL TEXT matches (the actual merge
    # key two processes share); a foreign layout passes through as
    # parsed and still merges exactly with other scrapes of itself.
    for canon in (DEFAULT_MS_BOUNDS, SECONDS_BOUNDS):
        if len(canon) == len(bounds) and all(
                f"{c:.12g}" == f"{b:.12g}"
                for c, b in zip(canon, bounds)):
            bounds = canon
            break
    hist = Histogram(bounds=bounds)
    counts = []
    prev = 0.0
    for le, cum in buckets:
        if cum < prev:
            raise ValueError(
                f"non-monotone cumulative bucket counts at le={le}")
        counts.append(int(cum - prev))
        prev = cum
    if int(buckets[-1][1]) != int(count):
        raise ValueError(
            f"+Inf bucket {buckets[-1][1]} != _count {count}")
    hist.counts = counts
    hist.sum = float(total_sum)
    hist.count = int(count)
    return hist
