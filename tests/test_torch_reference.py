"""The reference workload of the port against the JAX package's, on the CPU:
the MLPs, online Q-learning, PG and A2C, the per-step greedy eval and the
serving engine's generic program.

Inputs: a seeded random-walk series at price scale 1 with a budget of 5
(so the budget does not swamp the price features and the policies take
every action), numpy-seeded or JAX-initialised weights converted to the
port, and the JAX steps' own random draws recreated in their split order
and handed to the port through ``draws=``:

- Q-learning, per step ``rng, k_act = split(rng)``, ``split(k_act, B)``,
  and per agent ``k_gate, k_rand = split(key)``: ``uniform(k_gate)`` and
  ``randint(k_rand, (), 0, A)``;
- PG / A2C, per step ``rng, k_act = split(rng)``, ``split(k_act, B)``, and
  per agent the Gumbel noise ``jax.random.categorical`` adds to the logits.

Size: hidden 16, window 8, 4 agents, chunks of 12 steps. Tolerances, fp32:
- forwards: logits and values within 1e-6 relative (+1e-6 absolute: the
  same products summed in another order);
- Q-learning, one step at a time: the share change of every agent at every
  step (its effective action) equal, every step's loss within 1e-5
  relative; after a chunk, params and adagrad sums within
  1e-5 x (1 + max|leaf|), the metrics the same keys within 1e-5 relative;
- PG / A2C, one update: the loss and the squared gradients (the adagrad sum
  less its 0.1 start) within 1e-5 relative;
- greedy eval: per-tick rewards within 1e-3 (portfolio values reduced in
  another order), the final state within 1e-6 relative;
- serving: actions equal, logits within 1e-6 relative of ``apply_batch``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sharetrade_tpu.agents import build_agent as jax_build_agent
from sharetrade_tpu.config import FrameworkConfig as JaxConfig
from sharetrade_tpu.env import trading as jtrading
from sharetrade_tpu.models import mlp as jmlp
from sharetrade_tpu_torch import convert
from sharetrade_tpu_torch.agents import build_agent
from sharetrade_tpu_torch.agents import qlearn as tqlearn
from sharetrade_tpu_torch.agents import rollout as trollout
from sharetrade_tpu_torch.config import ConfigError, FrameworkConfig, ServeConfig
from sharetrade_tpu_torch.env.trading import make_trading_env
from sharetrade_tpu_torch.models import mlp as tmlp
from sharetrade_tpu_torch.serve import ServeEngine

AGENTS, STEPS, WINDOW, HIDDEN, BUDGET = 4, 12, 8, 16, 5.0
OBS = WINDOW + 2


def _prices(n=60, seed=0):
    rng = np.random.default_rng(seed)
    steps = rng.uniform(0.01, 0.03, n) * rng.choice([-1.0, 1.0], n)
    return np.exp(np.cumsum(steps)).astype(np.float32)


def _overrides(algo, *extra):
    return [f"learner.algo={algo}", "model.kind=mlp",
            f"model.hidden_dim={HIDDEN}", f"env.window={WINDOW}",
            f"env.initial_budget={BUDGET}", f"parallel.num_workers={AGENTS}",
            f"runtime.chunk_steps={STEPS}", *extra]


def _close(got, want, rtol, err_msg=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * (1.0 + np.abs(want).max()),
                               err_msg=err_msg)


class _Pair:
    """The same learner in both packages, the port's state converted from
    the JAX init."""

    def __init__(self, algo, *extra, prices=None, model=None):
        prices = _prices() if prices is None else prices
        overrides = _overrides(algo, *extra)
        jmodel, tmodel = model or (None, None)
        self.jagent = jax_build_agent(
            JaxConfig().apply_overrides(overrides),
            jtrading.make_trading_env(prices, window=WINDOW,
                                      initial_budget=BUDGET), model=jmodel)
        self.tenv = make_trading_env(prices, window=WINDOW,
                                     initial_budget=BUDGET, device="cpu")
        self.tagent = build_agent(FrameworkConfig().apply_overrides(overrides),
                                  self.tenv, tmodel, device="cpu")
        self.jts = self.jagent.init(jax.random.PRNGKey(5))
        self.tts = convert.train_state_from_jax(
            jax.tree.map(np.asarray, self.jts))


def qlearn_draws(rng, steps, agents=AGENTS, actions=3):
    """The JAX Q-learning step's epsilon-greedy draws, in its split order."""
    gate, rand = [], []
    for _ in range(steps):
        rng, k_act = jax.random.split(rng)
        keys = jax.random.split(k_act, agents)
        pairs = [jax.random.split(k) for k in keys]
        gate.append([float(jax.random.uniform(k)) for k, _ in pairs])
        rand.append([int(jax.random.randint(k, (), 0, actions, jnp.int32))
                     for _, k in pairs])
    return rng, tqlearn.Draws(torch.tensor(gate, dtype=torch.float32),
                              torch.tensor(rand, dtype=torch.int64))


def gumbel_draws(rng, steps, agents=AGENTS, actions=3):
    """The JAX generic rollout's categorical noise, in its split order."""
    noise = []
    for _ in range(steps):
        rng, k_act = jax.random.split(rng)
        noise.append(np.stack([
            np.asarray(jax.random.gumbel(k, (actions,), jnp.float32))
            for k in jax.random.split(k_act, agents)]))
    return torch.tensor(np.stack(noise))


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind,parity", [("q", True), ("q", False),
                                         ("ac", False)])
def test_mlp_forward_matches_jax(kind, parity):
    if kind == "q":
        jmodel = jmlp.q_mlp(OBS, HIDDEN, 3, parity=parity)
        tmodel = tmlp.q_mlp(OBS, HIDDEN, 3, parity=parity)
    else:
        jmodel, tmodel = jmlp.ac_mlp(OBS, HIDDEN, 3), tmlp.ac_mlp(OBS, HIDDEN, 3)
    jparams = jmodel.init(jax.random.PRNGKey(1))
    tparams = convert.params_from_jax(jax.tree.map(np.asarray, jparams))
    # The port's init draws the same tree (names, shapes, dtypes).
    tinit = tmodel.init(torch.Generator().manual_seed(1))
    assert sorted(convert.flatten(convert.params_to_numpy(tinit))) == \
        sorted(convert.flatten(jax.tree.map(np.asarray, jparams)))
    obs = np.random.default_rng(2).uniform(0.5, 2.0, (6, OBS)).astype(
        np.float32)
    jout, _ = jax.vmap(lambda o: jmodel.apply(jparams, o, ()))(obs)
    tout, carry = tmodel.apply_batch(tparams, torch.from_numpy(obs), {})
    assert carry == {}
    np.testing.assert_allclose(tout.logits.numpy(), np.asarray(jout.logits),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        tout.value.numpy(),
        np.broadcast_to(np.asarray(jout.value, np.float32), (6,)),
        rtol=1e-6, atol=1e-6)


def test_argmax_ties_pick_the_first_index():
    """The parity Q-network's output ReLU makes all-zero rows: both
    packages' greedy choice is then action 0."""
    q = np.zeros((3, 3), np.float32)
    q[1, 1:] = 2.0
    assert np.asarray(jnp.argmax(q, axis=-1)).tolist() == \
        torch.argmax(torch.from_numpy(q), dim=-1).tolist() == [0, 1, 0]
    gate = torch.zeros(3)          # below any exploit probability > 0
    step = torch.tensor(1000, dtype=torch.int32)
    cfg = FrameworkConfig().learner
    got = tqlearn.epsilon_greedy(torch.from_numpy(q), gate,
                                 torch.full((3,), 2), step, cfg)
    assert got.tolist() == [0, 1, 0]


# ---------------------------------------------------------------------------
# Q-learning
# ---------------------------------------------------------------------------

def _q_models(parity):
    return (jmlp.q_mlp(OBS, HIDDEN, 3, parity=parity),
            tmlp.q_mlp(OBS, HIDDEN, 3, parity=parity, device="cpu"))


@pytest.mark.parametrize("taken,parity", [(True, False), (False, True)],
                         ids=["taken_action", "reference_bug_parity"])
def test_qlearn_step_by_step_matches_jax(taken, parity):
    """Chunks of one step: every step's effective actions and loss."""
    pair = _Pair("qlearn", "runtime.chunk_steps=1",
                 f"learner.update_taken_action={str(taken).lower()}",
                 "learner.epsilon_ramp_steps=6", model=_q_models(parity))
    jstep = jax.jit(pair.jagent.step)
    jts, tts = pair.jts, pair.tts
    moves = set()
    for _ in range(STEPS):
        shares0 = tts.env_state.shares.clone()
        _, draws = qlearn_draws(jts.rng, 1)
        jts, jm = jstep(jts)
        tts, tm = pair.tagent.step(tts, draws=draws)
        np.testing.assert_array_equal(tts.env_state.shares.numpy(),
                                      np.asarray(jts.env_state.shares))
        moves.update((tts.env_state.shares - shares0).tolist())
        _close(float(tm["loss"]), float(jm["loss"]), 1e-5, "loss")
    assert moves == {-1.0, 0.0, 1.0}     # buys, sells and holds all ran


@pytest.mark.parametrize("taken,parity", [(True, False), (False, True)],
                         ids=["taken_action", "reference_bug_parity"])
def test_qlearn_chunk_matches_jax(taken, parity):
    pair = _Pair("qlearn",
                 f"learner.update_taken_action={str(taken).lower()}",
                 "learner.epsilon_ramp_steps=20", model=_q_models(parity))
    jts, tts = pair.jts, pair.tts
    for _ in range(2):
        _, draws = qlearn_draws(jts.rng, STEPS)
        jts, jm = jax.jit(pair.jagent.step)(jts)
        tts, tm = pair.tagent.step(tts, draws=draws)
    got = convert.train_state_to_numpy(tts)
    for field in ("t", "budget", "shares", "share_value"):
        _close(got["env_state"][field], getattr(jts.env_state, field), 1e-6,
               field)
    for a, b in zip(jax.tree.leaves(got["params"]),
                    jax.tree.leaves(jts.params)):
        _close(a, b, 1e-5)
    for a, b in zip(jax.tree.leaves(got["opt_state"][0].sum_of_squares),
                    jax.tree.leaves(jts.opt_state[0].sum_of_squares)):
        _close(a, b, 1e-5)
    assert set(tm) == set(jm)
    for key in jm:
        _close(float(tm[key]), float(jm[key]), 1e-5, key)


def test_qlearn_past_the_horizon_keeps_adam_state():
    """A 6-step series under 12-step chunks: the last 6 steps of the first
    chunk and the whole second chunk have no active agent, so the update
    is gated off: params, adam's moments and count, and the counters stay
    where the JAX step's ``where(any_active, ...)`` keeps them."""
    pair = _Pair("qlearn", "learner.optimizer=adam",
                 prices=_prices(WINDOW + 6))
    jts, tts = pair.jts, pair.tts
    for _ in range(2):
        _, draws = qlearn_draws(jts.rng, STEPS)
        jts, jm = jax.jit(pair.jagent.step)(jts)
        tts, tm = pair.tagent.step(tts, draws=draws)
        assert int(tts.opt_state[0].count) == int(jts.opt_state[0].count) == 6
        assert int(tm["updates"]) == int(jm["updates"]) == 6
        assert int(tm["env_steps"]) == 6
    for a, b in zip(jax.tree.leaves(convert.params_to_numpy(tts.params)),
                    jax.tree.leaves(jts.params)):
        _close(a, b, 1e-5)
    for part in ("mu", "nu"):
        for a, b in zip(
                jax.tree.leaves(convert.params_to_numpy(
                    getattr(tts.opt_state[0], part))),
                jax.tree.leaves(getattr(jts.opt_state[0], part))):
            _close(a, b, 1e-5, part)


def test_q_head_needs_the_mlp():
    cfg = FrameworkConfig().apply_overrides(
        _overrides("qlearn", "model.kind=transformer",
                   "model.seq_mode=episode"))
    with pytest.raises(ValueError, match="model.kind='mlp'"):
        build_agent(cfg, make_trading_env(_prices(), window=WINDOW,
                                          device="cpu"), device="cpu")


# ---------------------------------------------------------------------------
# PG and A2C
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("algo", ["pg", "a2c"])
def test_policy_gradient_update_matches_jax(algo):
    pair = _Pair(algo)
    noise = gumbel_draws(pair.jts.rng, STEPS)
    jts, jm = jax.jit(pair.jagent.step)(pair.jts)
    tts, tm = pair.tagent.step(pair.tts, draws=noise)
    assert set(tm) == set(jm)
    for key in jm:
        _close(float(tm[key]), float(jm[key]), 1e-5, key)
    assert float(jm["reward_sum"]) != 0.0          # the policy traded
    for field in ("budget", "shares", "t"):
        _close(getattr(tts.env_state, field).numpy(),
               getattr(jts.env_state, field), 1e-6, field)
    # Squared gradients: the adagrad sums less their 0.1 start.
    sums = convert.opt_state_to_numpy(tts.opt_state)[0].sum_of_squares
    for a, b in zip(jax.tree.leaves(sums),
                    jax.tree.leaves(jts.opt_state[0].sum_of_squares)):
        _close(a - 0.1, np.asarray(b) - 0.1, 1e-5)
    for a, b in zip(jax.tree.leaves(convert.params_to_numpy(tts.params)),
                    jax.tree.leaves(jts.params)):
        _close(a, b, 1e-5)


def test_discounted_returns_match_jax():
    from sharetrade_tpu.agents import rollout as jrollout
    rng = np.random.default_rng(4)
    rewards = rng.standard_normal((9, 5)).astype(np.float32)
    active = (rng.uniform(size=(9, 5)) > 0.2).astype(np.float32)
    bootstrap = rng.standard_normal(5).astype(np.float32)
    want = jrollout.discounted_returns(rewards, active, bootstrap, 0.9)
    got = trollout.discounted_returns(torch.from_numpy(rewards),
                                      torch.from_numpy(active),
                                      torch.from_numpy(bootstrap), 0.9)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# greedy eval and serving
# ---------------------------------------------------------------------------

def _trading_q_params():
    """Q-network weights (``parity=False``) whose greedy policy takes every
    action on the series: hidden units read the share count, the last price
    move up and down (x20); Q_buy = 2 - shares + up, Q_sell = shares - 2 +
    down, Q_hold = 0.5, so the holding swings around two shares."""
    w1 = np.zeros((OBS, HIDDEN), np.float32)
    w1[WINDOW + 1, 0] = 1.0                          # shares
    w1[WINDOW - 1, 1], w1[WINDOW - 2, 1] = 20.0, -20.0     # price up
    w1[WINDOW - 1, 2], w1[WINDOW - 2, 2] = -20.0, 20.0     # price down
    w2 = np.zeros((HIDDEN, 3), np.float32)
    w2[0] = [-1.0, 1.0, 0.0]
    w2[1, 0] = w2[2, 1] = 1.0
    return {"layer1": {"w": w1, "b": np.zeros(HIDDEN, np.float32)},
            "layer2": {"w": w2, "b": np.array([2.0, -2.0, 0.5], np.float32)}}


def _random_params(model, seed=3):
    """The init redrawn from a numpy seed at std 1 / sqrt(fan-in), biases
    0.5."""
    rng = np.random.default_rng(seed)
    flat = convert.flatten(convert.params_to_numpy(
        model.init(torch.Generator().manual_seed(0))))
    for name, leaf in flat.items():
        flat[name] = ((rng.standard_normal(leaf.shape) / np.sqrt(leaf.shape[0])
                       if name.endswith(".w") else np.full_like(leaf, 0.5))
                      .astype(np.float32))
    return convert.unflatten(flat)


def test_greedy_eval_per_step_matches_jax(tmp_path):
    """300 ticks through both orchestrators' ``evaluate()``, the port's on
    its per-step greedy replay."""
    from sharetrade_tpu.runtime import Orchestrator as JaxOrchestrator
    from sharetrade_tpu_torch.runtime import Orchestrator

    prices = _prices(WINDOW + 300, seed=6)
    overrides = _overrides("qlearn")
    jorch = JaxOrchestrator(JaxConfig().apply_overrides(
        overrides + [f"runtime.checkpoint_dir={tmp_path / 'jax'}"]))
    jorch.send_training_data(prices)
    torch_orch = Orchestrator(FrameworkConfig().apply_overrides(
        overrides + [f"runtime.checkpoint_dir={tmp_path / 'torch'}"]),
        device="cpu")
    torch_orch.send_training_data(prices)
    params = _trading_q_params()
    jorch._ts = jorch.train_state.replace(
        params=jax.tree.map(jnp.asarray, params))
    torch_orch._ts = torch_orch.train_state.replace(
        params=convert.params_from_jax(params))

    model = torch_orch.agent.model
    actions = []

    def spy(p, obs, carry):
        out, carry = model.apply_batch(p, obs, carry)
        actions.append(int(torch.argmax(out.logits, dim=-1)[0]))
        return out, carry

    spied = dataclasses.replace(model, apply_batch=spy)
    tfinal, trewards = trollout.greedy_rollout(spied, torch_orch.env,
                                               torch_orch.train_state.params,
                                               {})
    assert np.bincount(actions, minlength=3).min() >= 5, actions
    jresult, tresult = jorch.evaluate(), torch_orch.evaluate()
    assert set(tresult) == set(jresult)
    assert tresult["eval_portfolio"] == pytest.approx(
        jresult["eval_portfolio"], rel=1e-6)
    assert tresult["eval_reward_sum"] == pytest.approx(
        jresult["eval_reward_sum"], abs=300 * 1e-3)
    np.testing.assert_allclose(trewards.sum().item(),
                               tresult["eval_reward_sum"], rtol=1e-6)
    assert int(tfinal.t[0]) == 300


@pytest.mark.parametrize("kind", ["q", "ac"])
def test_generic_engine_serves_the_mlps(kind):
    """The generic program (no prefill/serve pair): responses equal
    ``apply_batch`` on the same rows, through evictions (9 sessions on 4
    slots)."""
    model = (tmlp.q_mlp(OBS, HIDDEN, 3, parity=False, device="cpu")
             if kind == "q" else tmlp.ac_mlp(OBS, HIDDEN, 3, device="cpu"))
    params = convert.params_from_jax(_random_params(model))
    engine = ServeEngine(model, ServeConfig(max_batch=3, slots=4,
                                            batch_timeout_ms=50.0), params)
    rng = np.random.default_rng(8)
    try:
        engine.warmup()
        for _ in range(4):
            obs = rng.uniform(0.5, 5.0, (9, OBS)).astype(np.float32)
            handles = [engine.submit(f"s{i}", obs[i]) for i in range(9)]
            results = [h.wait(30.0) for h in handles]
            want, _ = model.apply_batch(params, torch.from_numpy(obs), {})
            got = np.stack([r.logits for r in results])
            np.testing.assert_allclose(got, want.logits.numpy(), rtol=1e-6,
                                       atol=1e-6)
            assert [r.action for r in results] == \
                torch.argmax(want.logits, dim=-1).tolist()
            np.testing.assert_allclose([r.value for r in results],
                                       want.value.numpy(), rtol=1e-6,
                                       atol=1e-6)
        counters = engine.counters
        assert counters["generic_batches"] > 0 and counters["evictions"] > 0
        assert counters["cold_batches"] == counters["warm_batches"] == 0
    finally:
        engine.stop(timeout_s=10.0)


def test_a_model_with_no_forward_is_refused():
    model = dataclasses.replace(tmlp.q_mlp(OBS, HIDDEN, 3, device="cpu"),
                                apply_batch=None)
    with pytest.raises(ConfigError, match="apply_batch"):
        ServeEngine(model, ServeConfig(max_batch=2, slots=2), {})
