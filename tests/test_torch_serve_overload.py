"""The port's serving engine under overload and faults, on the CPU: the
JAX package's semantics tests (tests/test_serve_robustness.py:130-420)
mirrored on the port's engine, plus its load drivers.

- Admission control: a flood past ``serve.max_queue`` is rejected
  (``shed_policy="reject"``) or sheds the oldest queued request
  (``"oldest"``), each loser completed at once with ``ServeRejected``,
  counted exactly, the queue bounded, and the engine serves on.
- Deadlines: an expired request completes with ``ServeDeadlineExceeded``
  before batch collection (``submit(deadline_ms=)`` and
  ``serve.default_deadline_ms``), and the coalescing wait is clamped to the
  earliest surviving deadline.
- Supervision (``serve.max_restarts``): a malformed observation fails its
  batch and rebuilds the engine; the formerly warm session then answers as
  a fresh one, bit for bit; a storm of faults ends in the terminal state
  (``ServeEngineFailed``) and ``stop`` is still clean.
- Shutdown honesty: ``drain(timeout)`` reports False while work is in
  flight, ``stop`` reports a thread it could not join.
- The drivers: ``run_open_loop``'s counts reconcile with the engine's
  (completed + failed = offered - dropped, failed = shed + expired), and
  ``BatchOneServer`` (one B = 1 call per request) agrees with the JAX
  per-session functions within ``ATOL`` (the episode transformer) and with
  the JAX MLP's ``apply``.

A stalled consumer (a completion callback that blocks on an event) makes
requests pile into the bounded queue deterministically; no test sleeps a
fixed time for it.
"""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sharetrade_tpu.models.transformer_episode import (
    episode_transformer_policy as jax_policy)
from sharetrade_tpu_torch import convert
from sharetrade_tpu_torch.config import ConfigError, ModelConfig, ServeConfig
from sharetrade_tpu_torch.models import build_model
from sharetrade_tpu_torch.models.transformer_episode import (
    episode_transformer_policy as torch_policy)
from sharetrade_tpu_torch.serve import (
    ServeDeadlineExceeded, ServeEngine, ServeEngineFailed, ServeRejected)
from sharetrade_tpu_torch.serve.driver import (
    BatchOneServer, make_sessions, run_closed_loop, run_open_loop)
from sharetrade_tpu_torch.utils.metrics import MetricsRegistry

WINDOW = 8
OBS_DIM = WINDOW + 2
ATOL = 1e-5
ARCH = dict(num_layers=1, num_heads=2, head_dim=16)


@pytest.fixture(scope="module")
def prices():
    rng = np.random.default_rng(7)
    return rng.uniform(10.0, 20.0, 256).astype(np.float32)


@pytest.fixture(scope="module")
def mlp():
    model = build_model(ModelConfig(kind="mlp", hidden_dim=16), OBS_DIM,
                        device="cpu")
    return model, model.init(torch.Generator().manual_seed(1))


@pytest.fixture(scope="module")
def episode():
    model = torch_policy(OBS_DIM, 3, device="cpu", **ARCH)
    return model, model.init(torch.Generator().manual_seed(0))


def obs_at(prices, start, t):
    lo = start + t
    return np.concatenate([prices[lo:lo + WINDOW],
                           [2400.0, 0.0]]).astype(np.float32)


def _stalled_engine(model, params, prices, *, max_queue, shed_policy,
                    registry=None, **cfg):
    """An engine whose consumer is held inside one request's completion
    callback (done_depth 1), so later submits fill the ingress queue.
    Returns (engine, stall handle, release event)."""
    engine = ServeEngine(
        model, ServeConfig(max_batch=2, slots=4, batch_timeout_ms=1.0,
                           max_queue=max_queue, shed_policy=shed_policy,
                           **cfg),
        params, registry=registry, done_depth=1)
    engine.warmup()
    engaged, release = threading.Event(), threading.Event()

    def stall(_result):
        engaged.set()
        release.wait(30.0)

    handle = engine.submit("stall", obs_at(prices, 0, 0), callback=stall)
    assert engaged.wait(20.0), "stall request never dispatched"
    return engine, handle, release


@pytest.mark.parametrize("knobs", [
    {"max_queue": 0}, {"shed_policy": "brownout"},
    {"default_deadline_ms": -1.0}, {"max_restarts": -1},
    {"restart_backoff_s": 0.0}])
def test_new_knob_validation(mlp, knobs):
    with pytest.raises(ConfigError):
        ServeEngine(mlp[0], ServeConfig(max_batch=1, slots=1, **knobs),
                    mlp[1])


def test_flood_rejects_with_explicit_outcome(mlp, prices):
    registry = MetricsRegistry()
    engine, stall, release = _stalled_engine(
        *mlp, prices, max_queue=4, shed_policy="reject", registry=registry)
    try:
        handles = [engine.submit(f"f{i}", obs_at(prices, i % 32, 0))
                   for i in range(64)]
        assert engine.queue_depth() <= 4
        rejected = [h for h in handles if h._event.is_set()
                    and h.result is None]
        assert rejected, "a flood past max_queue=4 rejected nothing"
        for handle in rejected:
            assert isinstance(handle.error, ServeRejected)
            assert handle.error.reason == "queue_full"
        release.set()
        for handle in handles:
            handle.wait(30.0)
        counters = registry.counters()
        assert counters["serve_queue_rejected_total"] == len(rejected)
        assert "serve_shed_total" not in counters
        assert registry.latest("serve_overload") == 1.0
        assert engine.submit("after", obs_at(prices, 40, 0)).wait(30.0)
    finally:
        release.set()
        assert stall.wait(10.0) is not None
        engine.stop()


def test_flood_shed_oldest_admits_newest(mlp, prices):
    registry = MetricsRegistry()
    engine, stall, release = _stalled_engine(
        *mlp, prices, max_queue=4, shed_policy="oldest", registry=registry)
    try:
        handles = [engine.submit(f"o{i}", obs_at(prices, i % 32, 0))
                   for i in range(64)]
        assert engine.queue_depth() <= 4
        release.set()
        shed = [h for h in handles if h.wait(30.0) is None]
        assert shed, "the flood shed nothing"
        for handle in shed:
            assert isinstance(handle.error, ServeRejected)
            assert handle.error.reason == "shed_oldest"
            assert handle.wait(0.001) is None       # already terminal
        assert handles[-1].result is not None
        assert registry.counters()["serve_shed_total"] == len(shed)
    finally:
        release.set()
        assert stall.wait(10.0) is not None
        engine.stop()


def test_deadline_expires_before_batch_collection(mlp, prices):
    """Requests whose deadline has passed when the dispatcher reaches them
    complete with ServeDeadlineExceeded, counted exactly; traffic without a
    deadline is served."""
    registry = MetricsRegistry()
    engine, stall, release = _stalled_engine(
        *mlp, prices, max_queue=16, shed_policy="reject", registry=registry)
    try:
        # A budget already spent (negative) is expired on arrival.
        handles = [engine.submit(f"d{i}", obs_at(prices, i, 0),
                                 deadline_ms=-1.0) for i in range(8)]
        release.set()
        assert all(h.wait(30.0) is None for h in handles)
        assert all(isinstance(h.error, ServeDeadlineExceeded)
                   for h in handles)
        assert registry.counters()["serve_deadline_expired_total"] == 8
        assert engine.submit("ok", obs_at(prices, 50, 0)).wait(30.0)
    finally:
        release.set()
        assert stall.wait(10.0) is not None
        engine.stop()


def test_default_deadline_from_config(mlp, prices):
    registry = MetricsRegistry()
    engine, stall, release = _stalled_engine(
        *mlp, prices, max_queue=16, shed_policy="reject", registry=registry,
        default_deadline_ms=1.0)
    try:
        handles = [engine.submit(f"dd{i}", obs_at(prices, i, 0))
                   for i in range(8)]
        t_due = time.perf_counter() + 0.002
        while time.perf_counter() < t_due:      # the 1 ms deadlines pass
            pass
        release.set()
        expired = [h for h in handles if h.wait(30.0) is None]
        assert len(expired) == 8
        assert all(isinstance(h.error, ServeDeadlineExceeded)
                   for h in expired)
        # deadline_ms=0 overrides the default: no deadline.
        assert engine.submit("nodl", obs_at(prices, 60, 0),
                             deadline_ms=0).wait(30.0) is not None
    finally:
        release.set()
        assert stall.wait(10.0) is not None
        engine.stop()


def test_deadline_anchors_batch_coalescing(mlp, prices):
    """A lone request with a 50 ms deadline under a 2 s coalescing timeout
    dispatches at its deadline, not at the timeout."""
    engine = ServeEngine(mlp[0], ServeConfig(max_batch=8, slots=8,
                                             batch_timeout_ms=2000.0),
                         mlp[1])
    engine.warmup()
    try:
        t0 = time.perf_counter()
        result = engine.submit("anchor", obs_at(prices, 0, 0),
                               deadline_ms=50.0).wait(10.0)
        assert result is not None
        assert time.perf_counter() - t0 < 1.5
    finally:
        engine.stop()


def test_supervised_restart_rebuilds_arena(episode, prices):
    """max_restarts > 0: the malformed observation fails its batch and the
    engine is rebuilt; session A, warm before, then answers bit for bit as
    a fresh session does, and the restart is counted once."""
    model, params = episode
    registry = MetricsRegistry()
    engine = ServeEngine(
        model, ServeConfig(max_batch=4, slots=8, batch_timeout_ms=2.0,
                           max_restarts=2, restart_backoff_s=0.01,
                           restart_backoff_max_s=0.05),
        params, registry=registry, restart_seed=0)
    engine.warmup()
    fresh = ServeEngine(model, ServeConfig(max_batch=4, slots=8), params)
    try:
        for t in range(2):
            assert engine.submit("A", obs_at(prices, 0, t)).wait(30.0)
        bad = engine.submit("bad", np.ones(3, np.float32))
        assert bad.wait(30.0) is None and bad.error is not None
        o = obs_at(prices, 0, 2)
        healed = engine.submit("A", o).wait(60.0)
        want = fresh.submit("A-fresh", o).wait(60.0)
        assert healed is not None and np.array_equal(healed.logits,
                                                     want.logits)
        assert registry.counters()["serve_restarts_total"] == 1.0
    finally:
        engine.stop()
        fresh.stop()


def test_restart_storm_trips_terminal_failed(mlp, prices):
    registry = MetricsRegistry()
    engine = ServeEngine(
        mlp[0], ServeConfig(max_batch=2, slots=2, batch_timeout_ms=1.0,
                            max_restarts=1, restart_backoff_s=0.01,
                            restart_backoff_max_s=0.02),
        mlp[1], registry=registry, restart_seed=0)
    engine.warmup()
    try:
        assert engine.submit("s1", np.ones(3, np.float32)).wait(30.0) is None
        assert engine.submit("s2", np.ones(3, np.float32)).wait(30.0) is None
        deadline = time.monotonic() + 10.0
        while engine.failed is None and time.monotonic() < deadline:
            time.sleep(0.005)
        assert engine.failed is not None
        with pytest.raises(ServeEngineFailed):
            engine.submit("late", obs_at(prices, 0, 0))
        assert registry.counters()["serve_restarts_total"] == 1.0
        assert registry.latest("serve_failed") == 1.0
    finally:
        assert engine.stop(drain=False) is True


def test_drain_timeout_returns_false(mlp, prices):
    engine, stall, release = _stalled_engine(
        *mlp, prices, max_queue=8, shed_policy="reject")
    try:
        assert engine.drain(timeout_s=0.05) is False
        release.set()
        assert engine.drain(timeout_s=20.0) is True
    finally:
        release.set()
        assert stall.wait(10.0) is not None
        assert engine.stop() is True


def test_stop_reports_hung_thread(mlp, prices):
    engine, stall, release = _stalled_engine(
        *mlp, prices, max_queue=8, shed_policy="reject")
    assert engine.stop(drain=False, timeout_s=0.2) is False
    release.set()
    assert stall.wait(10.0) is not None
    assert engine.stop(drain=False, timeout_s=10.0) is True


def test_open_loop_counts_reconcile_under_overload(mlp, prices):
    """Open loop far past what a stalled-free 1-row engine serves, 64
    sessions over an 8-deep queue, shedding the oldest with 5 ms
    deadlines: every arrival is accounted for."""
    registry = MetricsRegistry()
    engine = ServeEngine(
        mlp[0], ServeConfig(max_batch=1, slots=2, batch_timeout_ms=0.0,
                            max_queue=8, shed_policy="oldest",
                            default_deadline_ms=5.0),
        mlp[1], registry=registry)
    engine.warmup()
    try:
        stats = run_open_loop(
            engine, make_sessions(prices, WINDOW, 64, prefix="o"),
            rate_qps=20000.0, duration_s=0.5)
    finally:
        engine.stop()
    counters = registry.counters()
    shed = counters.get("serve_shed_total", 0)
    expired = counters.get("serve_deadline_expired_total", 0)
    assert stats["mode"] == "open_loop" and stats["offered"] > 0
    assert stats["completed"] + stats["failed"] == \
        stats["offered"] - stats["dropped"]
    assert stats["failed"] == shed + expired > 0
    assert stats["completed"] > 0


def test_batch_one_server_matches_jax_per_session(prices):
    """The batch-1 baseline threads each session's carry on the device
    through the prefill then the B = 1 serving step: its answers agree
    with the JAX per-session functions within ATOL, and it drives the
    closed-loop harness."""
    masters = jax_policy(OBS_DIM, 3, **ARCH).init(jax.random.PRNGKey(3))
    jm = jax_policy(OBS_DIM, 3, use_pallas=True, **ARCH)
    prefill, serve = jax.jit(jm.apply_prefill), jax.jit(jm.apply_serve_batch)
    server = BatchOneServer(
        torch_policy(OBS_DIM, 3, device="cpu", **ARCH),
        convert.params_from_jax(jax.tree.map(np.asarray, masters)))
    server.warmup()
    carries: dict = {}
    try:
        for t in range(3):
            for sid, start in (("a", 0), ("b", 30)):
                o = obs_at(prices, start, t)
                got = server.submit(sid, o).wait(30.0)
                x = jnp.asarray(o[None])
                out, carries[sid] = (
                    serve(masters, x, carries[sid]) if sid in carries
                    else prefill(masters, x))
                np.testing.assert_allclose(got.logits,
                                           np.asarray(out.logits[0]),
                                           atol=ATOL, rtol=0)
                assert got.value == pytest.approx(float(out.value[0]),
                                                  abs=ATOL)
                assert got.action == int(np.argmax(got.logits))
        stats = run_closed_loop(server, make_sessions(prices, WINDOW, 4),
                                concurrency=1, duration_s=0.2)
    finally:
        assert server.stop()
    assert stats["completed"] > 0 and stats["failed"] == 0


def test_batch_one_server_generic_models_match_jax_apply(prices):
    """A model without a serving pair (the MLP) through ``apply_batch`` at
    B = 1, against the JAX MLP's ``apply``."""
    from sharetrade_tpu.config import ModelConfig as JaxModelConfig
    from sharetrade_tpu.models import build_model as jax_build

    jm = jax_build(JaxModelConfig(kind="mlp", hidden_dim=16), OBS_DIM,
                   head="ac")
    masters = jm.init(jax.random.PRNGKey(2))
    server = BatchOneServer(
        build_model(ModelConfig(kind="mlp", hidden_dim=16), OBS_DIM,
                    device="cpu"),
        convert.params_from_jax(jax.tree.map(np.asarray, masters)))
    server.warmup()
    try:
        for t in range(3):
            o = obs_at(prices, 5, t)
            got = server.submit("m", o).wait(30.0)
            out, _ = jm.apply(masters, jnp.asarray(o), jm.init_carry())
            np.testing.assert_allclose(got.logits, np.asarray(out.logits),
                                       atol=ATOL, rtol=0)
    finally:
        server.stop()
