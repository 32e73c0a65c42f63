"""The port's ``obs/hist.py`` against the JAX package's, on the CPU.

The same seeded numpy samples go through both packages' ``Histogram``:
the bucket layouts are the same tuples, the bucket counts are identical,
quantiles agree within 1e-12, and ``merge`` / ``from_prom_buckets``
round-trip across the packages (a histogram of one package merges into, and
is rebuilt by, the other's). ``serve_stage_p99s`` reads the same registry
rows in both.
"""

import math

import numpy as np
import pytest

from sharetrade_tpu.obs import hist as jhist
from sharetrade_tpu.obs import serve_stage_p99s as j_stage_p99s
from sharetrade_tpu.utils.metrics import MetricsRegistry as JRegistry
from sharetrade_tpu_torch.obs import SERVE_STAGES
from sharetrade_tpu_torch.obs import hist as thist
from sharetrade_tpu_torch.obs import serve_stage_p99s as t_stage_p99s
from sharetrade_tpu_torch.utils.metrics import MetricsRegistry as TRegistry

QUANTILES = (0.0, 0.01, 0.25, 0.5, 0.9, 0.99, 0.999, 1.0)


def _samples(seed, n=5000):
    """Log-normal latencies around 2 ms, a few past the top bucket and a
    few exactly on bucket bounds (the ``le`` edge)."""
    rng = np.random.default_rng(seed)
    x = rng.lognormal(mean=math.log(2.0), sigma=1.5, size=n)
    x[:5] = 2e6
    x[5:10] = thist.DEFAULT_MS_BOUNDS[7]
    return x


def _pair(samples, bounds=None):
    j, t = jhist.Histogram(bounds), thist.Histogram(bounds)
    for v in samples:
        j.observe(v)
        t.observe(v)
    return j, t


def test_layouts_are_the_same_tuples():
    assert thist.DEFAULT_MS_BOUNDS == jhist.DEFAULT_MS_BOUNDS
    assert thist.SECONDS_BOUNDS == jhist.SECONDS_BOUNDS
    for spec in ((0.01, 1e5, 5), (1e-4, 1e3, 5), (0.5, 700.0, 3)):
        assert thist.log_bounds(spec[0], spec[1], per_decade=spec[2]) == \
            jhist.log_bounds(spec[0], spec[1], per_decade=spec[2])
    with pytest.raises(ValueError):
        thist.log_bounds(1.0, 0.5)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("layout", ["ms", "seconds"])
def test_counts_identical_and_quantiles_equal(seed, layout):
    bounds = None if layout == "ms" else thist.SECONDS_BOUNDS
    samples = _samples(seed) / (1.0 if layout == "ms" else 1e3)
    half = len(samples) // 2
    j, t = _pair(samples[:half], bounds)
    base = t.snapshot()["counts"]
    for v in samples[half:]:
        j.observe(v)
        t.observe(v)
    js, ts = j.snapshot(), t.snapshot()
    assert ts["counts"] == js["counts"]
    assert ts["count"] == js["count"] == len(samples)
    assert ts["sum"] == pytest.approx(js["sum"], rel=1e-12)
    for q in QUANTILES:
        assert abs(t.quantile(q) - j.quantile(q)) <= 1e-12
        assert abs(thist.quantile_from_snapshot(ts, q)
                   - jhist.quantile_from_snapshot(js, q)) <= 1e-12
    # A window delta (the serve gauges' math) is the histogram of the
    # second half alone, in both packages.
    delta = [a - b for a, b in zip(ts["counts"], base)]
    _, alone = _pair(samples[half:], bounds)
    assert delta == alone.snapshot()["counts"]
    for q in QUANTILES:
        assert abs(t.quantile(q, counts=delta)
                   - j.quantile(q, counts=delta)) <= 1e-12


def test_empty_and_overflow_edges_agree():
    j, t = jhist.Histogram(), thist.Histogram()
    assert t.quantile(0.99) == j.quantile(0.99) == 0.0
    for h in (j, t):
        h.observe(1e9)
    assert t.quantile(0.5) == j.quantile(0.5) == thist.DEFAULT_MS_BOUNDS[-1]
    with pytest.raises(ValueError):
        thist.Histogram(bounds=(1.0, 1.0))


def test_merge_across_packages_is_exact():
    j1, t1 = _pair(_samples(3))
    j2, t2 = _pair(_samples(4))
    # Each package's histogram merges into the other's.
    mixed_t = thist.merge([t1, j2])
    mixed_j = jhist.merge([j1, t2])
    assert mixed_t.snapshot()["counts"] == mixed_j.snapshot()["counts"]
    assert mixed_t.count == mixed_j.count == 10000
    want = [a + b for a, b in zip(j1.snapshot()["counts"],
                                  j2.snapshot()["counts"])]
    assert mixed_t.snapshot()["counts"] == want
    for q in QUANTILES:
        assert abs(mixed_t.quantile(q) - mixed_j.quantile(q)) <= 1e-12
    with pytest.raises(ValueError):
        thist.Histogram().merge(thist.Histogram(thist.SECONDS_BOUNDS))
    with pytest.raises(ValueError):
        thist.merge([])


def _prom(h):
    """The Prometheus exposition of a histogram as a scraper parses it:
    ``(le label text, cumulative count)`` with the ``%.12g`` labels."""
    snap = h.snapshot()
    out, cum = [], 0
    for b, c in zip(snap["bounds"], snap["counts"]):
        cum += c
        out.append((f"{b:.12g}", cum))
    cum += snap["counts"][-1]
    out.append(("+Inf", cum))
    return out, snap["sum"], snap["count"]


def test_from_prom_buckets_round_trips_across_packages():
    j, t = _pair(_samples(5))
    for src, rebuild, other in ((t, jhist.from_prom_buckets, jhist),
                                (j, thist.from_prom_buckets, thist)):
        buckets, total, count = _prom(src)
        back = rebuild(buckets, total, count)
        # The labels snap back to the canonical layout: it merges exactly
        # with an in-process histogram of the rebuilding package.
        assert back.bounds == other.DEFAULT_MS_BOUNDS
        assert back.snapshot()["counts"] == src.snapshot()["counts"]
        merged = other.merge([back, other.Histogram()])
        assert merged.count == src.count
    buckets, total, count = _prom(t)
    with pytest.raises(ValueError):
        thist.from_prom_buckets(buckets[:-1], total, count)
    with pytest.raises(ValueError):
        thist.from_prom_buckets(buckets, total, count + 1)
    bad = list(buckets)
    bad[3] = (bad[3][0], bad[2][1] - 1)
    with pytest.raises(ValueError):
        thist.from_prom_buckets(bad, total, count)


def test_stage_p99s_read_the_same_rows():
    rng = np.random.default_rng(9)
    jreg, treg = JRegistry(), TRegistry()
    for stage in SERVE_STAGES[:3]:       # readback left empty: omitted
        jh = jreg.attach_histogram(f"serve_{stage}_ms", jhist.Histogram())
        th = treg.attach_histogram(f"serve_{stage}_ms", thist.Histogram())
        for v in rng.exponential(3.0, 400):
            jh.observe(v)
            th.observe(v)
    treg.attach_histogram("serve_readback_ms", thist.Histogram())
    got = t_stage_p99s(treg)
    assert got == j_stage_p99s(jreg)
    assert set(got) == set(SERVE_STAGES[:3])
