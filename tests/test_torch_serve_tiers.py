"""The port's session tiers (``serve.warm_bytes``, ``serve.spill_dir``)
against the JAX package, on the CPU.

- ``WarmStore`` (tests/test_session_paging.py:120-166, mirrored): the same
  operation sequences through the JAX class and the port's (parametrized by
  package) give the same demotions, bytes, refusals and pops; a seeded
  random sequence runs through both in lockstep.
- The engine with the warm tier, and with the warm and spill tiers, over a
  trace of rounds in which sessions are evicted, parked, re-installed,
  spilled and adopted: every answer within ``ATOL`` of the JAX per-session
  functions (``_prefill`` for a session's first request,
  ``_incremental_serve`` with B = 1 after, as tests/test_torch_serve.py's
  ``_Oracle``; a parked or spilled session continues, so the oracle never
  restarts one), and bit-equal to the port's engine run with a slot for
  every session (never evicted).
- The JAX semantics tests, mirrored on the port's engine:
  test_session_paging.py:183-302 (warm unpark bitwise, overflow to cold,
  undersized budget, stateless models, validation) and
  test_spill_tier.py:307-450 (adoption after ``page_out_all`` bitwise,
  corrupt and stale records cold, the park/eviction race, the drain
  ordering, validation). "Bitwise" is held against the port's own
  never-evicted engine or a fresh session, as the JAX tests hold theirs.
- Records cross the packages: a carry the JAX package seals is adopted by
  the port's engine (its leaves bit for bit the JAX carry's, its next
  answer within ``ATOL`` of the JAX incremental step), and a carry the
  port's engine pages out is read back by the JAX arena and split by the
  JAX engine's own ``_rows_from_payload`` into the port's carry bit for bit,
  in float32 and bfloat16.

Tolerance: ``ATOL 1e-5`` on logits and values against JAX (fp32; the
episode-model test states why the features agree that far); exact within
the port.
"""

import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sharetrade_tpu.models.transformer_episode import (
    episode_transformer_policy as jax_policy)
from sharetrade_tpu.serve import engine as jengine
from sharetrade_tpu.serve import spill as jspill
from sharetrade_tpu_torch import convert
from sharetrade_tpu_torch.config import ConfigError, ModelConfig, ServeConfig
from sharetrade_tpu_torch.models import build_model
from sharetrade_tpu_torch.models.core import tree_leaves
from sharetrade_tpu_torch.models.transformer_episode import (
    episode_transformer_policy as torch_policy)
from sharetrade_tpu_torch.precision import PrecisionPolicy
from sharetrade_tpu_torch.serve import ServeEngine, SlotPool, WarmStore
from sharetrade_tpu_torch.serve import spill as tspill
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
def model():
    return torch_policy(OBS_DIM, 3, device="cpu", **ARCH)


@pytest.fixture(scope="module")
def params(model):
    return model.init(torch.Generator().manual_seed(0))


def obs_at(prices, start, t):
    lo = start + t
    return np.concatenate([prices[lo:lo + WINDOW],
                           [2400.0, 0.0]]).astype(np.float32)


def _carry_nbytes(model, precision=None) -> int:
    carry = model.init_carry()
    if precision is not None:
        carry = precision.cast_carry(carry, model)
    return sum(x.numel() * x.element_size() for x in tree_leaves(carry))


def _engine(model, params, *, slots=2, max_batch=2, registry=None,
            precision=None, **cfg):
    engine = ServeEngine(
        model, ServeConfig(max_batch=max_batch, slots=slots,
                           batch_timeout_ms=2.0, **cfg), params,
        registry=registry or MetricsRegistry(),
        **({"precision": precision} if precision else {}))
    engine.warmup()
    return engine


def _ask(engine, sid, obs, **kw):
    result = engine.submit(sid, obs, **kw).wait(30.0)
    assert result is not None, sid
    return result


def _same(a, b) -> bool:
    return np.array_equal(a.logits, b.logits) and a.value == b.value


def _sealed(root) -> list[str]:
    return sorted(f for f in os.listdir(root)
                  if f.endswith(tspill.SPILL_SUFFIX))


def _flip(path) -> None:
    raw = bytearray(open(path, "rb").read())
    raw[int(len(raw) * 0.99)] ^= 0xFF
    open(path, "wb").write(bytes(raw))


# ---------------------------------------------------------------------------
# WarmStore against the JAX class


STORES = {"jax": jengine.WarmStore, "port": WarmStore}


@pytest.fixture(params=sorted(STORES))
def store_cls(request):
    return STORES[request.param]


def test_warm_store_lru_demotes_stalest_and_hits_refresh(store_cls):
    store = store_cls(max_bytes=300, max_sessions=64)
    for i, sid in enumerate(("a", "b", "c")):
        assert store.put(sid, rows=sid.upper(), nbytes=100, steps=i + 1) == []
    assert store.bytes == 300 and len(store) == 3
    assert store.pop("a") == ("A", 1) and store.bytes == 200
    assert store.put("a", "A2", 100, steps=4) == []
    assert store.put("d", "D", 100) == [("b", "B", 100, 2)]
    assert store.demotions == 1 and store.pop("b") is None
    assert store.pop("a") == ("A2", 4)


def test_warm_store_refusals_bounds_and_replace(store_cls):
    store = store_cls(max_bytes=100, max_sessions=64)
    assert store.put("big", "X", 101) == [] and store.refusals == 1
    assert store.put("junk", "Y", 0) == [] and store.refusals == 2
    assert len(store) == 0 and store.bytes == 0
    bounded = store_cls(max_bytes=1 << 20, max_sessions=2)
    bounded.put("a", "A", 10)
    bounded.put("b", "B", 10)
    assert bounded.put("c", "C", 10) == [("a", "A", 10, 0)]
    replaced = store_cls(max_bytes=250, max_sessions=64)
    replaced.put("a", "A", 100)
    replaced.put("a", "A2", 200)
    assert replaced.bytes == 200 and replaced.pop("a") == ("A2", 0)
    replaced.put("b", "B", 100, steps=3)
    replaced.discard("b")
    replaced.discard("b")
    assert replaced.pop("b") is None and replaced.bytes == 0


def test_warm_store_lockstep_random_operations():
    """200 seeded puts (sizes around the budget), pops and discards
    through both classes: every return value and counter equal."""
    rng = np.random.default_rng(3)
    stores = {k: cls(max_bytes=500, max_sessions=4)
              for k, cls in STORES.items()}
    for step in range(200):
        op = rng.choice(["put", "pop", "discard", "contains"])
        sid = f"s{rng.integers(8)}"
        nbytes = int(rng.integers(0, 260))
        steps = int(rng.integers(5))
        outs = {}
        for k, store in stores.items():
            if op == "put":
                outs[k] = store.put(sid, sid.upper(), nbytes, steps)
            elif op == "pop":
                outs[k] = store.pop(sid)
            elif op == "discard":
                outs[k] = store.discard(sid)
            else:
                outs[k] = store.contains(sid)
        assert outs["jax"] == outs["port"], (step, op)
        state = {k: (s.bytes, len(s), s.demotions, s.refusals)
                 for k, s in stores.items()}
        assert state["jax"] == state["port"], (step, op)


def test_slot_pool_lru_order_and_pinned_exemption():
    pool = SlotPool(capacity=3)
    for sid in ("a", "b", "c"):
        assert pool.admit(sid, pinned=set())[1] is None
    pool.lookup("a")
    assert pool.admit("d", pinned=set())[1] == "b"
    assert pool.admit("e", pinned={"c"})[1] == "a"
    assert pool.evictions == 2 and pool.contains("c")


# ---------------------------------------------------------------------------
# the engine over a trace, against JAX and against itself never evicted


class _JaxSessions:
    """Each session threaded alone through the JAX model: the prefill for
    its first request, the B = 1 incremental step after (it is never
    restarted: the tiers keep every carry)."""

    def __init__(self, masters):
        jm = jax_policy(OBS_DIM, 3, use_pallas=True, **ARCH)
        self.prefill = jax.jit(jm.apply_prefill)
        self.serve = jax.jit(jm.apply_serve_batch)
        self.params = masters
        self.carries: dict = {}

    def step(self, sid, obs):
        x = jnp.asarray(obs[None])
        if sid in self.carries:
            out, self.carries[sid] = self.serve(self.params, x,
                                                self.carries[sid])
        else:
            out, self.carries[sid] = self.prefill(self.params, x)
        return np.asarray(out.logits[0]), float(out.value[0])


@pytest.mark.parametrize("tier", ["warm", "warm+spill"])
def test_tiered_engine_matches_jax_and_the_never_evicted_engine(
        tier, prices, tmp_path):
    """7 sessions over 3 slots, 12 rounds of 3 distinct sessions: the
    tiered engine's answers within ``ATOL`` of the JAX per-session
    functions and bit-equal to a port engine with a slot for every
    session; the tiers parked, re-installed (and spilled and adopted)."""
    masters = jax_policy(OBS_DIM, 3, **ARCH).init(jax.random.PRNGKey(4))
    params = convert.params_from_jax(jax.tree.map(np.asarray, masters))
    model = torch_policy(OBS_DIM, 3, device="cpu", **ARCH)
    nbytes = _carry_nbytes(model)
    knobs = ({"warm_bytes": 16 * nbytes} if tier == "warm" else
             {"warm_bytes": nbytes, "spill_dir": str(tmp_path),
              "spill_bytes": 1 << 24})
    registry = MetricsRegistry()
    tiered = _engine(model, params, slots=3, max_batch=3, registry=registry,
                     **knobs)
    never = _engine(model, params, slots=7, max_batch=3)
    oracle = _JaxSessions(masters)
    rng = np.random.default_rng(5)
    starts = {f"s{i}": 20 * i for i in range(7)}
    clocks = dict.fromkeys(starts, 0)
    try:
        for r in range(12):
            sids = [f"s{i}" for i in rng.choice(7, 3, replace=False)]
            obs = [obs_at(prices, starts[s], clocks[s]) for s in sids]
            got = [h.wait(30.0) for h in
                   [tiered.submit(s, o) for s, o in zip(sids, obs)]]
            ref = [h.wait(30.0) for h in
                   [never.submit(s, o) for s, o in zip(sids, obs)]]
            for sid, o, g, w in zip(sids, obs, got, ref):
                assert g is not None and _same(g, w), (r, sid)
                logits, value = oracle.step(sid, o)
                np.testing.assert_allclose(g.logits, logits, atol=ATOL,
                                           rtol=0)
                assert g.value == pytest.approx(value, abs=ATOL)
                clocks[sid] += 1
        counters = registry.counters()
    finally:
        tiered.stop(timeout_s=10.0)
        never.stop(timeout_s=10.0)
    assert counters["serve_warm_parks_total"] > 0
    assert counters["serve_warm_hits_total"] > 0
    assert counters["serve_prefills_total"] == 7      # first requests only
    if tier != "warm":
        assert counters["serve_spill_puts_total"] > 0
        assert counters["serve_spill_hits_total"] > 0


# ---------------------------------------------------------------------------
# test_session_paging.py, mirrored


def test_warm_unpark_is_bitwise_uninterrupted(model, params, prices):
    registry = MetricsRegistry()
    engine = _engine(model, params, warm_bytes=1 << 20, registry=registry)
    never = _engine(model, params, slots=8)
    try:
        for t in range(3):
            assert _same(_ask(engine, "A", obs_at(prices, 0, t)),
                         _ask(never, "A", obs_at(prices, 0, t)))
        for sid, start in (("B", 40), ("C", 80)):
            _ask(engine, sid, obs_at(prices, start, 0))
        for t in range(3, 6):
            o = obs_at(prices, 0, t)
            assert _same(_ask(engine, "A", o), _ask(never, "A", o))
        counters = registry.counters()
    finally:
        engine.stop()
        never.stop()
    assert counters["serve_warm_parks_total"] >= 1
    assert counters["serve_warm_hits_total"] >= 1


def test_warm_overflow_demotes_to_cold_restart(model, params, prices):
    registry = MetricsRegistry()
    engine = _engine(model, params, warm_bytes=_carry_nbytes(model),
                     registry=registry)
    never = _engine(model, params, slots=8)
    try:
        for t in range(3):
            _ask(engine, "A", obs_at(prices, 0, t))
        _ask(engine, "B", obs_at(prices, 40, 0))
        _ask(never, "B", obs_at(prices, 40, 0))
        _ask(engine, "C", obs_at(prices, 80, 0))   # evicts A: parked
        _ask(engine, "D", obs_at(prices, 120, 0))  # evicts B: A demoted
        o = obs_at(prices, 40, 1)
        assert _same(_ask(engine, "B", o), _ask(never, "B", o))  # warm
        for t in range(3, 5):                      # A restarts cold
            o = obs_at(prices, 0, t)
            assert _same(_ask(engine, "A", o), _ask(never, "A-fresh", o))
        assert registry.counters()["serve_warm_demotions_total"] >= 1
    finally:
        engine.stop()
        never.stop()


def test_undersized_budget_refuses_and_stays_cold(model, params, prices):
    registry = MetricsRegistry()
    engine = _engine(model, params, warm_bytes=1, registry=registry)
    never = _engine(model, params, slots=8)
    try:
        for t in range(3):
            _ask(engine, "A", obs_at(prices, 0, t))
        for sid, start in (("B", 40), ("C", 80)):
            _ask(engine, sid, obs_at(prices, start, 0))
        for t in range(3, 5):
            o = obs_at(prices, 0, t)
            assert _same(_ask(engine, "A", o), _ask(never, "A-fresh", o))
        assert engine._warm.refusals >= 1
        assert registry.counters().get("serve_warm_hits_total", 0) == 0
    finally:
        engine.stop()
        never.stop()


def test_warm_disabled_for_stateless_model(prices):
    mlp = build_model(ModelConfig(kind="mlp", hidden_dim=16), OBS_DIM,
                      device="cpu")
    registry = MetricsRegistry()
    engine = _engine(mlp, mlp.init(torch.Generator().manual_seed(1)),
                     warm_bytes=1 << 20, registry=registry)
    try:
        assert engine._warm_enabled is False
        for sid, start in (("A", 0), ("B", 40), ("C", 80)):
            _ask(engine, sid, obs_at(prices, start, 0))
        counters = registry.counters()
        assert counters.get("serve_warm_parks_total", 0) == 0
        assert counters.get("serve_warm_misses_total", 0) == 0
    finally:
        engine.stop()


@pytest.mark.parametrize("knobs,match", [
    ({"warm_bytes": -1}, "warm_bytes"),
    ({"warm_max_sessions": 0}, "warm_max_sessions"),
    ({"spill_bytes": -1}, "spill_bytes"),
    ({"spill_dir": "somewhere", "warm_bytes": 0}, "spill_dir requires")])
def test_tier_config_validation(model, params, knobs, match):
    with pytest.raises(ConfigError, match=match):
        ServeEngine(model, ServeConfig(max_batch=1, slots=1, **knobs),
                    params)


# ---------------------------------------------------------------------------
# test_spill_tier.py, mirrored


def _spill_engine(model, params, spill_dir, *, warm_carries=1, slots=2,
                  registry=None, precision=None):
    return _engine(model, params, slots=slots, registry=registry,
                   precision=precision,
                   warm_bytes=warm_carries * _carry_nbytes(model, precision),
                   spill_dir=str(spill_dir), spill_bytes=1 << 26)


def test_spill_adoption_is_bitwise_uninterrupted(model, params, prices,
                                                 tmp_path):
    never = _engine(model, params, slots=8)
    sids = [(f"s{i}", i * 3) for i in range(4)]
    clock: dict = {}

    def send(engine, sid, t0, t):
        o = obs_at(prices, t0, t)
        got = _ask(engine, sid, o, session_clock=clock.get(sid) or None)
        assert _same(got, _ask(never, sid, o)), (sid, t)
        clock[sid] = clock.get(sid, 0) + 1

    a = _spill_engine(model, params, tmp_path)
    for rnd in range(3):
        for sid, t0 in sids:
            send(a, sid, t0, rnd)
    assert a.stop(timeout_s=30.0)
    assert a.page_out_all()["refused"] == 0
    assert len(_sealed(tmp_path)) == len(sids)
    reg_b = MetricsRegistry()
    b = _spill_engine(model, params, tmp_path, registry=reg_b)
    try:
        for rnd in range(3, 5):
            for sid, t0 in sids:
                send(b, sid, t0, rnd)
        counters = reg_b.counters()
        assert counters.get("serve_adopt_warm_total", 0) == len(sids)
        assert counters.get("serve_adopt_cold_total", 0) == 0
        assert counters.get("serve_spill_hits_total", 0) >= len(sids)
    finally:
        b.stop(drain=False, timeout_s=30.0)
        never.stop()


def test_corrupt_and_stale_records_land_cold_bitwise_fresh(
        model, params, prices, tmp_path):
    never = _engine(model, params, slots=8)
    a = _spill_engine(model, params, tmp_path)
    for sid, t0 in (("c0", 0), ("s0", 8)):
        for t in range(3):
            _ask(a, sid, obs_at(prices, t0, t))
    a.stop(timeout_s=30.0)
    assert a.page_out_all()["written"] == 2
    _flip(tmp_path / tspill.record_name("c0"))
    reg_b = MetricsRegistry()
    b = _spill_engine(model, params, tmp_path, registry=reg_b)
    try:
        o = obs_at(prices, 0, 3)
        assert _same(_ask(b, "c0", o, session_clock=3),
                     _ask(never, "c0-fresh", o))
        o = obs_at(prices, 8, 3)
        assert _same(_ask(b, "s0", o, session_clock=2),
                     _ask(never, "s0-fresh", o))
        counters = reg_b.counters()
        assert counters.get("serve_spill_corrupt_total", 0) == 1
        assert counters.get("serve_spill_stale_total", 0) == 1
        assert counters.get("serve_adopt_warm_total", 0) == 0
        assert counters.get("serve_adopt_cold_total", 0) == 2
        assert _sealed(tmp_path) == []
    finally:
        b.stop(drain=False, timeout_s=30.0)
        never.stop()


def test_park_inbox_commit_races_eviction_bitwise(model, params, prices):
    """Two sessions through ONE slot: every request evicts the other, whose
    page-out races the next admission; every answer bit-equal to the
    never-evicted engine."""
    registry = MetricsRegistry()
    engine = _engine(model, params, slots=1, max_batch=1,
                     warm_bytes=2 * _carry_nbytes(model), registry=registry)
    never = _engine(model, params, slots=2, max_batch=1)
    try:
        for t in range(6):
            for sid, t0 in (("a", 0), ("b", 16)):
                o = obs_at(prices, t0, t)
                assert _same(_ask(engine, sid, o), _ask(never, sid, o))
        counters = registry.counters()
        assert counters["serve_warm_parks_total"] >= 10
        assert counters["serve_warm_hits_total"] >= 10
    finally:
        engine.stop(drain=False, timeout_s=30.0)
        never.stop()


def test_page_out_all_refuses_until_stopped(model, params, prices,
                                            tmp_path):
    engine = _spill_engine(model, params, tmp_path, warm_carries=2)
    for sid, t0 in (("h0", 0), ("h1", 8), ("w0", 16)):
        _ask(engine, sid, obs_at(prices, t0, 0))
    with pytest.raises(RuntimeError, match=r"page_out_all\(\) before "
                                           r"stop\(\)"):
        engine.page_out_all()
    assert _sealed(tmp_path) == []
    assert engine.stop(timeout_s=30.0)
    out = engine.page_out_all()
    assert out["written"] == 3 and out["refused"] == 0
    assert _sealed(tmp_path) == sorted(tspill.record_name(s)
                                       for s in ("h0", "h1", "w0"))


def test_warmup_parks_no_session_even_if_the_dispatcher_commits(
        model, params, tmp_path):
    """``warmup`` runs the page-out's device work on a scratch row while the
    dispatcher thread already runs. Were that page-out queued, a dispatcher
    commit landing inside warmup (forced here, before the install) would
    park a "warmup" session in the warm store, and ``page_out_all`` would
    seal it into the arena as a fifth record beside the real sessions."""
    engine = ServeEngine(
        model, ServeConfig(max_batch=2, slots=2, batch_timeout_ms=2.0,
                           warm_bytes=4 * _carry_nbytes(model),
                           spill_dir=str(tmp_path), spill_bytes=1 << 26),
        params, registry=MetricsRegistry())
    install = engine._install

    def interleaved(rows, slots):
        engine._commit_page_outs(wait=True)   # the dispatcher, mid-warmup
        return install(rows, slots)

    engine._install = interleaved
    engine.warmup()
    engine._install = install
    assert len(engine._warm) == 0
    assert engine.stop(timeout_s=30.0)
    assert engine.page_out_all()["written"] == 0
    assert _sealed(tmp_path) == []


# ---------------------------------------------------------------------------
# records across the packages


def _jax_model_and_carry0(precision: str):
    jm = jax_policy(OBS_DIM, 3, use_pallas=True, **ARCH)
    carry0 = jm.init_carry()
    if precision == "bf16":
        carry0 = jm.cast_carry(carry0, jnp.bfloat16)
    return jm, carry0


def _port_precision(precision: str):
    return PrecisionPolicy(mode="bf16_mixed") if precision == "bf16" else None


def _bits(x) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(x)).reshape(-1).view(np.uint8)


def _port_bits(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().reshape(-1).view(torch.uint8).numpy()


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_port_sealed_carry_splits_bitwise_in_the_jax_engine(
        precision, model, params, prices, tmp_path):
    """The port's engine pages a session out at stop; the JAX arena takes
    the record and the JAX engine's ``_rows_from_payload`` splits it into
    the same leaves, bit for bit, as the port's arena row."""
    policy = _port_precision(precision)
    engine = _spill_engine(model, params, tmp_path, precision=policy)
    for t in range(3):
        _ask(engine, "x", obs_at(prices, 0, t))
    assert engine.stop(timeout_s=30.0)
    slot = engine._slots.lookup("x")
    row = [leaf[slot] for leaf in tree_leaves(engine._pool)]
    assert engine.page_out_all()["written"] == 1
    jm, carry0 = _jax_model_and_carry0(precision)
    payload, steps, reason, foreign = jspill.SpillArena(
        str(tmp_path), max_bytes=1 << 26,
        record_nbytes=_carry_nbytes(model, policy),
        incarnation="jax").take("x", expected_steps=3)
    assert (steps, reason, foreign) == (3, "hit", True)
    rows = jengine.ServeEngine._rows_from_payload(
        types.SimpleNamespace(_carry0=carry0), payload)
    jleaves = jax.tree.leaves(rows)
    assert len(jleaves) == len(row)
    for got, want in zip(jleaves, row):
        assert got.shape == tuple(want.shape)
        np.testing.assert_array_equal(_bits(got), _port_bits(want))


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_jax_sealed_carry_is_adopted_by_the_port_engine(precision, prices,
                                                        tmp_path):
    """A session's carry after two JAX steps, sealed by the JAX arena in
    ``jax.tree.leaves`` order: the port's engine adopts it through the
    session clock (its carry bit for bit the JAX one's), and its next
    answer agrees with the JAX incremental step from that carry (fp32:
    ``ATOL``; bf16: the adoption alone, bit for bit)."""
    masters = jax_policy(OBS_DIM, 3, **ARCH).init(jax.random.PRNGKey(9))
    jm, _ = _jax_model_and_carry0(precision)
    prefill, serve = jax.jit(jm.apply_prefill), jax.jit(jm.apply_serve_batch)
    _, carry = prefill(masters, jnp.asarray(obs_at(prices, 0, 0)[None]))
    _, carry = serve(masters, jnp.asarray(obs_at(prices, 0, 1)[None]), carry)
    if precision == "bf16":
        carry = jm.cast_carry(carry, jnp.bfloat16)
    host = jax.tree.map(lambda x: np.asarray(x)[0], carry)
    port_model = torch_policy(OBS_DIM, 3, device="cpu", **ARCH)
    policy = _port_precision(precision)
    assert jspill.SpillArena(
        str(tmp_path), max_bytes=1 << 26,
        record_nbytes=_carry_nbytes(port_model, policy),
        incarnation="jax").put("x", jax.tree.leaves(host), 2)
    engine = _spill_engine(
        port_model, convert.params_from_jax(jax.tree.map(np.asarray,
                                                         masters)),
        tmp_path, precision=policy)
    registry = engine.registry
    try:
        o = obs_at(prices, 0, 2)
        got = _ask(engine, "x", o, session_clock=2)
        assert registry.counters()["serve_adopt_warm_total"] == 1
        assert registry.counters().get("serve_prefills_total", 0) == 0
        if precision == "fp32":
            out, _ = serve(masters, jnp.asarray(o[None]), carry)
            np.testing.assert_allclose(got.logits, np.asarray(out.logits[0]),
                                       atol=ATOL, rtol=0)
            assert got.value == pytest.approx(float(out.value[0]), abs=ATOL)
    finally:
        engine.stop(timeout_s=30.0)
    # The adopted record, installed as the engine installs it (into a
    # scratch row of the stopped engine), is the JAX carry bit for bit.
    payload = b"".join(np.ascontiguousarray(x).tobytes()
                       for x in jax.tree.leaves(host))
    scratch = engine.cfg.slots
    with torch.inference_mode():
        engine._install([engine._rows_from_payload(payload)], [scratch])
    for got, want in zip(tree_leaves(engine._pool), jax.tree.leaves(host)):
        np.testing.assert_array_equal(_port_bits(got[scratch]), _bits(want))
