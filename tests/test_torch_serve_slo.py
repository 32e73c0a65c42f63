"""The port's serving telemetry and live knobs on the CPU, with ``q_mlp``.

- Every completed request's stages telescope to its latency
  (``serve_trace_decomposition_error_total`` stays 0), the five stage
  histograms are attached under the JAX names and count every completion.
- The windowed ``serve_p50_ms`` / ``serve_p99_ms`` equal the end-to-end
  histogram's quantiles of the window's bucket delta, and both lie within
  one bucket of the nearest-rank percentiles of the results.
- The SLO burn gauges under an event-driven stall (a completion callback
  that blocks on an event, no sleeps): rejections published from the
  submitting thread while nothing completes drive the availability burn
  past its threshold; the latency burn with an unmeetable target; the
  window math on explicit clocks (a clean window burns 0 and re-arms the
  alert); bad ``obs.slo_*`` values refused.
- The exemplar ring: the window's top K with their stage split.
- ``set_knobs``: config is the ceiling, bad values refused, the ingress
  bound retargeted, the gauges published; the answers across knob changes
  agree with the JAX engine's on the same params (converted) and
  observations within 1e-5.
"""

import threading

import jax.numpy as jnp
import numpy as np
import pytest

from sharetrade_tpu.config import ServeConfig as JServeConfig
from sharetrade_tpu.models import mlp as jmlp
from sharetrade_tpu.serve import ServeEngine as JServeEngine
from sharetrade_tpu_torch import convert
from sharetrade_tpu_torch.config import ConfigError, ObsConfig, ServeConfig
from sharetrade_tpu_torch.models import mlp as tmlp
from sharetrade_tpu_torch.obs import SERVE_STAGES
from sharetrade_tpu_torch.obs.hist import quantile_from_counts
from sharetrade_tpu_torch.serve import ServeEngine
from sharetrade_tpu_torch.serve.engine import _LiveKnobs, latency_percentiles
from sharetrade_tpu_torch.utils.metrics import MetricsRegistry

OBS, HIDDEN = 18, 16
ATOL = 1e-5


@pytest.fixture(scope="module")
def numpy_params():
    """q_mlp weights drawn with numpy (std 1/sqrt(fan-in), biases 0.5)."""
    rng = np.random.default_rng(5)
    return {"layer1": {"w": (rng.standard_normal((OBS, HIDDEN))
                             / np.sqrt(OBS)).astype(np.float32),
                       "b": np.full(HIDDEN, 0.5, np.float32)},
            "layer2": {"w": (rng.standard_normal((HIDDEN, 3))
                             / np.sqrt(HIDDEN)).astype(np.float32),
                       "b": np.full(3, 0.5, np.float32)}}


@pytest.fixture(scope="module")
def model_params(numpy_params):
    return (tmlp.q_mlp(OBS, HIDDEN, 3, parity=False, device="cpu"),
            convert.params_from_jax(numpy_params))


def _obs(rng, n):
    return rng.uniform(0.5, 5.0, (n, OBS)).astype(np.float32)


def _engine(model_params, *, obs_cfg=None, registry=None, **cfg):
    base = dict(max_batch=4, slots=16, batch_timeout_ms=2.0, max_queue=64,
                stats_interval_s=3600.0)
    base.update(cfg)
    engine = ServeEngine(*model_params[:1], ServeConfig(**base),
                         model_params[1], obs_cfg=obs_cfg,
                         registry=registry or MetricsRegistry())
    engine.warmup()
    return engine


def _serve(engine, obs, prefix="s"):
    """Submit over six sessions (at most 48 requests: the same-session
    backlog is bounded by max_queue) and wait; the drain returns once the
    consumer has also observed every completion."""
    handles = [engine.submit(f"{prefix}{i % 6}", o)
               for i, o in enumerate(obs)]
    results = [h.wait(30.0) for h in handles]
    assert engine.drain(30.0)
    return results


def test_stages_telescope_and_histograms_count(model_params):
    engine = _engine(model_params)
    try:
        results = _serve(engine, _obs(np.random.default_rng(0), 48))
        assert all(r is not None for r in results)
        for r in results:
            assert sum(r.stages.values()) == pytest.approx(r.latency_ms,
                                                           abs=1e-9)
            assert min(r.stages.values()) >= 0.0
        reg = engine.registry
        assert reg.counters().get(
            "serve_trace_decomposition_error_total", 0) == 0
        assert set(reg.histograms()) == {
            "serve_request_ms", *(f"serve_{s}_ms" for s in SERVE_STAGES)}
        for name, snap in reg.histograms().items():
            assert snap["count"] == len(results), name
        assert engine.latency_histogram is reg.histogram("serve_request_ms")
    finally:
        engine.stop(timeout_s=10.0)


def test_windowed_percentiles_are_the_window_delta(model_params):
    engine = _engine(model_params)
    try:
        rng = np.random.default_rng(1)
        _serve(engine, _obs(rng, 20), prefix="a")
        engine._publish_stats(force=True)       # close the first window
        hist = engine.latency_histogram
        base = hist.snapshot()["counts"]
        results = _serve(engine, _obs(rng, 48), prefix="b")
        engine._publish_stats(force=True)
        delta = [a - b for a, b in zip(hist.snapshot()["counts"], base)]
        assert sum(delta) == 48
        snap = engine.registry.snapshot()
        for q, gauge in ((0.5, "serve_p50_ms"), (0.99, "serve_p99_ms")):
            assert snap[gauge] == quantile_from_counts(hist.bounds, delta, q)
        # Within one bucket of the nearest-rank percentiles of the window.
        exact = latency_percentiles([r.latency_ms for r in results])
        for key in ("p50_ms", "p99_ms"):
            est, val = snap[f"serve_{key}"], exact[key]
            i = next(k for k, b in enumerate(hist.bounds) if val <= b)
            lo = hist.bounds[i - 1] if i else 0.0
            assert lo <= est <= hist.bounds[i], (key, est, val)
        assert snap["serve_qps"] > 0
        assert 0 < snap["serve_batch_occupancy"] <= 1.0
        assert snap["serve_sessions_hot"] == 12.0     # a0-a5, b0-b5
        assert snap["serve_overload"] == 0.0
    finally:
        engine.stop(timeout_s=10.0)


def test_availability_burn_climbs_while_nothing_completes(model_params):
    """The consumer is held inside one completion; rejections fail on the
    submitting thread and publish from there."""
    obs_cfg = ObsConfig(slo_availability=0.99, slo_burn_threshold=2.0,
                        slo_window_s=60.0)
    engine = ServeEngine(
        model_params[0], ServeConfig(max_batch=1, slots=4, max_queue=2,
                                     batch_timeout_ms=0.0,
                                     shed_policy="reject",
                                     stats_interval_s=0.0),
        model_params[1], obs_cfg=obs_cfg, registry=MetricsRegistry(),
        done_depth=1)
    engine.warmup()
    engaged, release = threading.Event(), threading.Event()
    rng = np.random.default_rng(2)

    def stall(_result):
        engaged.set()
        release.wait(30.0)

    try:
        stalled = engine.submit("stall", _obs(rng, 1)[0], callback=stall)
        assert engaged.wait(20.0)
        flood = [engine.submit(f"f{i}", o)
                 for i, o in enumerate(_obs(rng, 40))]
        rejected = [h for h in flood if h._event.is_set()
                    and h.result is None]
        assert rejected
        reg = engine.registry
        # Nothing has completed yet (the stalled request's completion is
        # still inside its callback), and the burn is already published.
        assert engine.counters["completed"] == 0
        burn = reg.latest("serve_slo_availability_burn")
        assert burn == pytest.approx(100.0)    # all bad, budget 1%
        assert reg.counters()["serve_slo_burn_alerts_total"] == 1
        assert reg.latest("serve_overload") == 1.0
        assert all(h.error.reason == "queue_full" for h in rejected)
        release.set()
        assert stalled.wait(10.0) is not None
        for h in flood:
            h.wait(10.0)
        assert engine.drain(10.0)
    finally:
        release.set()
        engine.stop(timeout_s=10.0)


def test_burn_window_math_and_latency_burn(model_params):
    obs_cfg = ObsConfig(slo_availability=0.9, slo_target_p99_ms=1e-6,
                        slo_window_s=10.0, slo_burn_threshold=2.0)
    engine = _engine(model_params, obs_cfg=obs_cfg)
    try:
        results = _serve(engine, _obs(np.random.default_rng(3), 12))
        engine._publish_stats(force=True)
        reg = engine.registry
        # Every completion is slower than 1 ns: the latency burn is 1/0.01.
        assert reg.latest("serve_slo_latency_burn") == pytest.approx(100.0)
        assert reg.latest("serve_slo_availability_burn") == 0.0
        assert len(results) == 12
        # The window math on explicit clocks. 100 s later with nothing new:
        # no outcome in the window, no gauge (the alert re-arms); then 10
        # bad of 20 burn (10/20)/0.1 = 5 and alert; 11 s on, a clean window
        # burns 0 and re-arms; the next bad window alerts again.
        t0 = engine._slo_win[-1][0]
        alerts = reg.counters()["serve_slo_burn_alerts_total"]
        total, bad, done, slow = engine._slo_win[-1][1:]
        assert engine._slo_burn(t0 + 100.0, (total, bad, done, slow)) == {}
        out = engine._slo_burn(t0 + 101.0, (total + 20, bad + 10,
                                            done + 10, slow))
        assert out["serve_slo_availability_burn"] == pytest.approx(5.0)
        assert out["serve_slo_latency_burn"] == 0.0
        out = engine._slo_burn(t0 + 112.0, (total + 40, bad + 10,
                                            done + 30, slow))
        assert out["serve_slo_availability_burn"] == 0.0
        out = engine._slo_burn(t0 + 113.0, (total + 50, bad + 20,
                                            done + 30, slow))
        assert out["serve_slo_availability_burn"] == pytest.approx(10 / 3)
        assert reg.counters()["serve_slo_burn_alerts_total"] == alerts + 2
    finally:
        engine.stop(timeout_s=10.0)


@pytest.mark.parametrize("field,value", [("slo_availability", 1.0),
                                         ("slo_availability", -0.1),
                                         ("slo_target_p99_ms", -1.0),
                                         ("slo_window_s", 0.0),
                                         ("slo_burn_threshold", 0.0)])
def test_bad_slo_settings_refused(model_params, field, value):
    with pytest.raises(ConfigError, match="obs.slo_"):
        ServeEngine(model_params[0], ServeConfig(max_batch=2, slots=2),
                    model_params[1], obs_cfg=ObsConfig(**{field: value}))


def test_exemplars_are_the_window_top_k(model_params):
    engine = _engine(model_params, obs_cfg=ObsConfig(exemplar_k=3))
    try:
        results = _serve(engine, _obs(np.random.default_rng(4), 40))
        ex = engine.exemplars()
        assert len(ex) == 3
        want = sorted((round(r.latency_ms, 3) for r in results),
                      reverse=True)[:3]
        assert [e["latency_ms"] for e in ex] == want
        for e in ex:
            assert set(e["stages"]) == {"queue_wait_ms", "batch_wait_ms",
                                        "device_ms"}
            assert sum(e["stages"].values()) == pytest.approx(
                e["latency_ms"], abs=2e-3)
            assert e["batch"] >= 1 and e["params_step"] == 0
        engine._publish_stats(force=True)       # fold into the ring
        assert engine.exemplars() == ex
        assert engine._window_slowest == []
    finally:
        engine.stop(timeout_s=10.0)
    off = _engine(model_params, obs_cfg=ObsConfig(exemplar_k=0))
    try:
        _serve(off, _obs(np.random.default_rng(4), 8))
        assert off.exemplars() == []
    finally:
        off.stop(timeout_s=10.0)


def test_set_knobs_ceilings_refusals_and_queue(model_params):
    engine = _engine(model_params, batch_timeout_ms=5.0, max_queue=64)
    try:
        assert engine.knobs == _LiveKnobs(5.0, 64)
        new = engine.set_knobs(batch_timeout_ms=500.0, max_queue=10_000)
        assert new == _LiveKnobs(5.0, 64)              # config is the ceiling
        new = engine.set_knobs(batch_timeout_ms=1.0, max_queue=8)
        assert new == engine.knobs == _LiveKnobs(1.0, 8)
        assert engine._q.maxsize == 8
        snap = engine.registry.snapshot()
        assert snap["serve_knob_batch_timeout_ms"] == 1.0
        assert snap["serve_knob_max_queue"] == 8.0
        assert engine.set_knobs(max_queue=16) == _LiveKnobs(1.0, 16)
        with pytest.raises(ConfigError):
            engine.set_knobs(batch_timeout_ms=-1.0)
        with pytest.raises(ConfigError):
            engine.set_knobs(max_queue=0)
        assert engine.knobs == _LiveKnobs(1.0, 16)
    finally:
        engine.stop(timeout_s=10.0)


def test_answers_across_knob_changes_match_jax(numpy_params, model_params):
    jparams = {k: {n: jnp.asarray(v) for n, v in d.items()}
               for k, d in numpy_params.items()}
    jengine = JServeEngine(jmlp.q_mlp(OBS, HIDDEN, 3, parity=False),
                           JServeConfig(max_batch=4, slots=16,
                                        batch_timeout_ms=5.0, max_queue=64),
                           jparams)
    tengine = _engine(model_params, batch_timeout_ms=5.0, max_queue=64)
    rng = np.random.default_rng(6)
    try:
        jengine.warmup()
        for knobs in ({}, {"batch_timeout_ms": 0.5, "max_queue": 16},
                      {"batch_timeout_ms": 0.0, "max_queue": 4},
                      {"batch_timeout_ms": 5.0, "max_queue": 64}):
            if knobs:
                assert tuple(tengine.set_knobs(**knobs)) == \
                    tuple(jengine.set_knobs(**knobs))
            obs = _obs(rng, 4)
            sids = [f"k{i}" for i in range(4)]
            got = [tengine.submit(s, o) for s, o in zip(sids, obs)]
            want = [jengine.submit(s, o) for s, o in zip(sids, obs)]
            got = [h.wait(30.0) for h in got]
            want = [h.wait(30.0) for h in want]
            for g, w in zip(got, want):
                np.testing.assert_allclose(g.logits, np.asarray(w.logits),
                                           atol=ATOL, rtol=0)
                assert g.value == pytest.approx(float(w.value), abs=ATOL)
                assert g.action == w.action
        assert tengine.registry.counters().get(
            "serve_trace_decomposition_error_total", 0) == 0
    finally:
        jengine.stop(drain=False)
        tengine.stop(timeout_s=10.0)


def test_every_outcome_counted_once_under_thread_stress(model_params):
    """Eight submitting threads flood a small queue (rejections on their
    own threads, completions on the consumer, publishes from both) with a
    shortened switch interval: the SLO totals count each request's one
    terminal outcome exactly once."""
    import sys
    obs_cfg = ObsConfig(slo_availability=0.99)
    engine = _engine(model_params, obs_cfg=obs_cfg, max_queue=4,
                     stats_interval_s=0.0)
    rng = np.random.default_rng(7)
    obs = _obs(rng, 8)
    handles, lock = [], threading.Lock()

    def flood(worker):
        mine = [engine.submit(f"w{worker}-{i % 3}", obs[i % 8])
                for i in range(150)]
        with lock:
            handles.extend(mine)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=flood, args=(w,))
                   for w in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60.0)
        assert not any(t.is_alive() for t in threads)
        assert engine.drain(60.0)
    finally:
        sys.setswitchinterval(interval)
        engine.stop(timeout_s=10.0)
    counters = engine.counters
    done = sum(1 for h in handles if h.result is not None)
    assert len(handles) == counters["requests"] == 1200
    assert engine._term_total == 1200
    assert engine._term_completed == counters["completed"] == done
    assert engine._term_bad == counters["failed"] == 1200 - done > 0
