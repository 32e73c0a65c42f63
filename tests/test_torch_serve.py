"""The port's serving engine against the JAX model functions, per session.

The slice as a whole: ``sharetrade_tpu_torch.serve.ServeEngine`` (CPU,
fp32) serves N sessions through a slot arena smaller than N, so LRU
evictions force cold re-prefill. The oracle threads each session ONE AT A
TIME through the JAX package's model functions — ``_prefill`` for a cold
session, ``_incremental_serve`` with B = 1 for a warm one — re-prefilling a
session from its current observation whenever the engine's LRU rule
(``SlotPool.admit`` at capacity ``serve.slots``: never evict a session of
the current batch, else the least recently used) would have evicted it.

Determinism: the engine is driven in synchronous rounds of exactly
``max_batch`` distinct sessions (a full batch never waits, and a long
``batch_timeout_ms`` keeps a round in one batch), so the LRU order is the
submission order. Both sides follow the same pre-drawn action sequence, so
near-tie argmax flips cannot fork an episode.

The JAX ``ServeEngine`` is not the oracle: its own bitwise parity tests
fail on this tree. Tolerance: logits and values ``atol 1e-5`` (fp32; the
episode-model test states why the features agree that far).
"""

from collections import OrderedDict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sharetrade_tpu.models.transformer_episode import (
    episode_transformer_policy as jax_policy)
from sharetrade_tpu_torch import convert
from sharetrade_tpu_torch.config import ConfigError, ServeConfig
from sharetrade_tpu_torch.env.trading import BUY, SELL
from sharetrade_tpu_torch.models.transformer_episode import (
    episode_transformer_policy as torch_policy)
from sharetrade_tpu_torch.serve import ServeEngine

WINDOW = 12
ATOL = 1e-5
SESSIONS, SLOTS, MAX_BATCH, ROUNDS = 7, 5, 3, 14


class _Session:
    """Prices (log-returns 1-3% in magnitude) and a portfolio that follows
    a pre-drawn action sequence."""

    def __init__(self, rng, length):
        steps = rng.uniform(0.01, 0.03, length) * rng.choice([-1.0, 1.0],
                                                             length)
        self.prices = (50.0 * np.exp(np.cumsum(steps))).astype(np.float32)
        self.actions = rng.integers(0, 3, length)
        self.t = 0
        self.budget, self.shares = 2400.0, 0.0

    def observation(self):
        return np.concatenate([self.prices[self.t:self.t + WINDOW],
                               [self.budget, self.shares]]).astype(np.float32)

    def advance(self):
        price = float(self.prices[self.t + WINDOW])
        action = self.actions[self.t]
        if action == BUY and self.budget >= price:
            self.budget, self.shares = self.budget - price, self.shares + 1
        elif action == SELL and self.shares > 0:
            self.budget, self.shares = self.budget + price, self.shares - 1
        self.t += 1


class _Oracle:
    """Per-session JAX model calls under the engine's LRU admission rule."""

    def __init__(self, params):
        model = jax_policy(WINDOW + 2, 3, num_layers=2, num_heads=2,
                           head_dim=16, use_pallas=True)
        self.prefill = jax.jit(model.apply_prefill)
        self.serve = jax.jit(model.apply_serve_batch)
        self.params = params
        self.carries: dict = {}
        self.lru: OrderedDict = OrderedDict()
        self.evictions = 0

    def round(self, sids, observations):
        pinned = set(sids)
        out = {}
        for sid, obs in zip(sids, observations):
            if sid in self.lru:
                self.lru.move_to_end(sid)
                res, self.carries[sid] = self.serve(
                    self.params, jnp.asarray(obs[None]), self.carries[sid])
            else:
                if len(self.lru) >= SLOTS:
                    victim = next(s for s in self.lru if s not in pinned)
                    del self.lru[victim]
                    del self.carries[victim]
                    self.evictions += 1
                self.lru[sid] = None
                res, self.carries[sid] = self.prefill(
                    self.params, jnp.asarray(obs[None]))
            out[sid] = (np.asarray(res.logits[0]), float(res.value[0]))
        return out


def test_engine_matches_per_session_jax_functions():
    masters = jax_policy(WINDOW + 2, 3, num_layers=2, num_heads=2,
                         head_dim=16).init(jax.random.PRNGKey(11))
    oracle = _Oracle(masters)
    model = torch_policy(WINDOW + 2, 3, num_layers=2, num_heads=2,
                         head_dim=16, device="cpu")
    cfg = ServeConfig(max_batch=MAX_BATCH, slots=SLOTS,
                      batch_timeout_ms=2000.0)
    engine = ServeEngine(model, cfg, convert.params_from_jax(
        jax.tree.map(np.asarray, masters)))
    engine.warmup()
    rng = np.random.default_rng(2)
    sessions = {f"s{i}": _Session(rng, ROUNDS + WINDOW + 2)
                for i in range(SESSIONS)}
    try:
        for r in range(ROUNDS):
            sids = [f"s{i}" for i in rng.choice(SESSIONS, MAX_BATCH,
                                                replace=False)]
            observations = [sessions[s].observation() for s in sids]
            handles = [engine.submit(s, o)
                       for s, o in zip(sids, observations)]
            results = [h.wait(60.0) for h in handles]
            want = oracle.round(sids, observations)
            for sid, res in zip(sids, results):
                assert res is not None, f"round {r}: {sid} failed"
                np.testing.assert_allclose(res.logits, want[sid][0],
                                           atol=ATOL, rtol=0)
                assert res.value == pytest.approx(want[sid][1], abs=ATOL)
                assert res.action == int(np.argmax(res.logits))
                sessions[sid].advance()
        counters = dict(engine.counters)
    finally:
        assert engine.stop(timeout_s=10.0)
    assert counters["evictions"] == oracle.evictions > 0
    assert counters["warm_rows"] > 0 and counters["failed"] == 0
    assert counters["batches"] == ROUNDS


def _engine(**cfg):
    model = torch_policy(WINDOW + 2, 3, num_layers=1, num_heads=2,
                         head_dim=16, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    return ServeEngine(model, ServeConfig(**cfg), params)


def test_full_queue_rejects_without_blocking():
    engine = _engine(max_batch=2, slots=2, max_queue=1,
                     batch_timeout_ms=0.0)
    try:
        obs = np.full(WINDOW + 2, 10.0, np.float32)
        handles = [engine.submit(f"s{i}", obs) for i in range(64)]
        for h in handles:
            h.wait(30.0)
        outcomes = [h.result is not None for h in handles]
        assert all(h._event.is_set() for h in handles)
        assert engine.counters["rejected"] == outcomes.count(False) > 0
    finally:
        engine.stop(timeout_s=10.0)


def test_slots_below_max_batch_refused():
    with pytest.raises(ConfigError):
        _engine(max_batch=4, slots=2)


def test_engine_serves_lstm_sessions_across_warm_and_cold_batches():
    """The generic program over the LSTM: each session's ``(h, c)`` lives in
    its arena slot (a tuple carry), a warm request continues it and a cold
    one (new, or evicted by the LRU rule) starts from the init carry. The
    oracle threads each session alone through the JAX LSTM's ``apply``
    under the same admission rule as :class:`_Oracle`; logits and values
    within ``ATOL``."""
    from sharetrade_tpu.models.lstm import lstm_policy as jax_lstm
    from sharetrade_tpu_torch.models.lstm import lstm_policy as torch_lstm

    jm = jax_lstm(WINDOW + 2, 16, 3)
    masters = jm.init(jax.random.PRNGKey(5))
    apply = jax.jit(jm.apply)
    engine = ServeEngine(
        torch_lstm(WINDOW + 2, 16, 3, device="cpu"),
        ServeConfig(max_batch=MAX_BATCH, slots=SLOTS,
                    batch_timeout_ms=2000.0),
        convert.params_from_jax(jax.tree.map(np.asarray, masters)))
    assert isinstance(engine._pool, tuple) and len(engine._pool) == 2
    rng = np.random.default_rng(3)
    sessions = {f"s{i}": _Session(rng, ROUNDS + WINDOW + 2)
                for i in range(SESSIONS)}
    carries: dict = {}
    lru: OrderedDict = OrderedDict()
    evictions = warm = 0
    try:
        engine.warmup()
        for r in range(ROUNDS):
            sids = [f"s{i}" for i in rng.choice(SESSIONS, MAX_BATCH,
                                                replace=False)]
            observations = [sessions[s].observation() for s in sids]
            handles = [engine.submit(s, o)
                       for s, o in zip(sids, observations)]
            results = [h.wait(60.0) for h in handles]
            for sid, obs, res in zip(sids, observations, results):
                if sid in lru:
                    lru.move_to_end(sid)
                    warm += 1
                else:
                    if len(lru) >= SLOTS:
                        victim = next(s for s in lru if s not in sids)
                        del lru[victim], carries[victim]
                        evictions += 1
                    lru[sid] = None
                    carries[sid] = jm.init_carry()
                out, carries[sid] = apply(masters, jnp.asarray(obs),
                                          carries[sid])
                assert res is not None, f"round {r}: {sid} failed"
                np.testing.assert_allclose(res.logits, np.asarray(out.logits),
                                           atol=ATOL, rtol=0)
                assert res.value == pytest.approx(float(out.value), abs=ATOL)
                sessions[sid].advance()
        counters = dict(engine.counters)
    finally:
        assert engine.stop(timeout_s=10.0)
    assert counters["evictions"] == evictions > 0
    assert counters["warm_rows"] == warm > 0
    assert counters["generic_batches"] == ROUNDS and counters["failed"] == 0
