"""The slice as a whole: one PPO chunk of each policy family through
``build_agent``, the port against the JAX package's, on the CPU; and one
A2C chunk on the LSTM.

Families: the window transformer (dense FFN; MoE top-0; MoE top-2 at
capacity factor 0.5, so picks drop), the LSTM, the TCN, and the window
transformer over the 2-asset portfolio env (5 actions, 2 x 13 tokens).
Each JAX agent is initialised from a seed and its ``TrainState``
converted to the port's (``convert.train_state_from_jax``; the LSTM's
``(h, c)`` carry as a tuple); the port's step receives the JAX step's own
draws through ``draws=``: per rollout step ``rng, k_act = split(rng)``,
``split(k_act, B)`` and per agent the Gumbel noise ``jax.random.categorical``
adds, then per epoch ``rng, k_perm = split(rng)`` and the permutation. Size:
window 12, 4 agents, unroll 8, 2 epochs x 2 minibatches, L 2, H 2, Dh 16,
4 experts, LSTM hidden 16, TCN 16 channels, adagrad.

Tolerances (float32), as tests/test_torch_ppo.py states them: actions,
rewards and env states equal (the env steps are the same float32
operations, and every sampled action agrees); counters equal; params within
1e-5 absolute; the adagrad sums of squared gradients within 1e-5 absolute
+ 1e-3 relative; the LSTM carry within 1e-5 absolute; the chunk's metrics
(loss terms, reward sum, portfolio statistics) within 1e-4 absolute + 1e-4
relative (sums over agents and tokens in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sharetrade_tpu.agents import build_agent as jax_build_agent
from sharetrade_tpu.config import FrameworkConfig as JaxConfig
from sharetrade_tpu.env import trading as jtrading
from sharetrade_tpu.env.portfolio import make_portfolio_env as jax_portfolio
from sharetrade_tpu_torch import convert
from sharetrade_tpu_torch.agents import build_agent
from sharetrade_tpu_torch.agents.ppo import Draws
from sharetrade_tpu_torch.config import FrameworkConfig
from sharetrade_tpu_torch.env.portfolio import make_portfolio_env
from sharetrade_tpu_torch.env.trading import make_trading_env

AGENTS, UNROLL, EPOCHS, WINDOW = 4, 8, 2, 12
BASE = ["learner.algo=ppo", f"env.window={WINDOW}",
        f"parallel.num_workers={AGENTS}", f"runtime.chunk_steps={UNROLL}",
        f"learner.ppo_epochs={EPOCHS}", "learner.ppo_minibatches=2"]
TRANSFORMER = ["model.kind=transformer", "model.num_layers=2",
               "model.num_heads=2", "model.head_dim=16"]
FAMILIES = {
    "transformer": TRANSFORMER,
    "moe_top0": TRANSFORMER + ["model.moe_experts=4"],
    "moe_top2": TRANSFORMER + ["model.moe_experts=4", "model.moe_top_k=2",
                               "model.moe_capacity_factor=0.5"],
    "lstm": ["model.kind=lstm", "model.hidden_dim=16"],
    "tcn": ["model.kind=tcn", "model.hidden_dim=16"],
    "portfolio": TRANSFORMER,
}


def _prices(assets=1):
    rng = np.random.default_rng(0)
    steps = rng.uniform(0.01, 0.03, (assets, 60)) * rng.choice(
        [-1.0, 1.0], (assets, 60))
    return (50.0 * np.exp(np.cumsum(steps, axis=1))).astype(np.float32)


def _pair(family, *extra):
    overrides = BASE + FAMILIES[family] + list(extra)
    if family == "portfolio":
        prices = _prices(2)
        jenv = jax_portfolio(prices, window=WINDOW)
        tenv = make_portfolio_env(prices, window=WINDOW, device="cpu")
    else:
        prices = _prices()[0]
        jenv = jtrading.make_trading_env(prices, window=WINDOW)
        tenv = make_trading_env(prices, window=WINDOW, device="cpu")
    jagent = jax_build_agent(JaxConfig().apply_overrides(overrides), jenv)
    tagent = build_agent(FrameworkConfig().apply_overrides(overrides), tenv,
                         device="cpu")
    jts = jagent.init(jax.random.PRNGKey(3))
    tts = convert.train_state_from_jax(jax.tree.map(np.asarray, jts))
    return jagent, tagent, jts, tts, jenv.num_actions


def _gumbel(rng, actions):
    """The JAX generic rollout's categorical noise; returns (rng, noise)."""
    noise = []
    for _ in range(UNROLL):
        rng, k_act = jax.random.split(rng)
        noise.append(np.stack([
            np.asarray(jax.random.gumbel(k, (actions,), jnp.float32))
            for k in jax.random.split(k_act, AGENTS)]))
    return rng, torch.tensor(np.stack(noise))


def _ppo_draws(rng, actions):
    rng, gumbel = _gumbel(rng, actions)
    perms = []
    for _ in range(EPOCHS):
        rng, k_perm = jax.random.split(rng)
        perms.append(np.asarray(jax.random.permutation(k_perm, AGENTS)))
    return Draws(gumbel, torch.tensor(np.stack(perms)))


def _compare(jts, jm, tts, tm):
    t = convert.train_state_to_numpy(tts)
    for field in ("t", "budget", "shares", "share_value"):
        np.testing.assert_array_equal(
            t["env_state"][field], np.asarray(getattr(jts.env_state, field)),
            err_msg=field)
    assert int(t["env_steps"]) == int(jts.env_steps)
    assert int(t["updates"]) == int(jts.updates)
    jflat = convert.flatten(jax.tree.map(np.asarray, jts.params))
    tflat = convert.flatten(t["params"])
    assert sorted(jflat) == sorted(tflat)
    for k in jflat:
        np.testing.assert_allclose(tflat[k], jflat[k], atol=1e-5, rtol=0,
                                   err_msg=k)
    for got, want in zip(
            jax.tree.leaves(t["opt_state"][0].sum_of_squares),
            jax.tree.leaves(jts.opt_state[0].sum_of_squares)):
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-3)
    jcarry = jax.tree.leaves(jts.carry)
    tcarry = [np.asarray(c) for c in t["carry"]] if isinstance(
        t["carry"], (list, tuple)) else list(t["carry"].values())
    assert len(tcarry) == len(jcarry)
    for got, want in zip(tcarry, jcarry):
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=0)
    assert set(tm) == set(jm)
    for key in jm:
        assert np.isfinite(float(tm[key])), key
        np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                   rtol=1e-4, atol=1e-4, err_msg=key)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_one_ppo_chunk_matches_jax(family):
    jagent, tagent, jts, tts, actions = _pair(family)
    draws = _ppo_draws(jts.rng, actions)
    jts2, jm = jax.jit(jagent.step)(jts)
    tts2, tm = tagent.step(tts, draws=draws)
    assert int(jts2.env_steps) == UNROLL
    if family == "lstm":
        assert isinstance(tts2.carry, tuple)
    if family == "moe_top2":
        assert float(jm["loss"]) != 0.0
    _compare(jts2, jm, tts2, tm)


def test_one_a2c_chunk_on_the_lstm_matches_jax():
    jagent, tagent, jts, tts, actions = _pair("lstm", "learner.algo=a2c")
    _, gumbel = _gumbel(jts.rng, actions)
    jts2, jm = jax.jit(jagent.step)(jts)
    tts2, tm = tagent.step(tts, draws=gumbel)
    _compare(jts2, jm, tts2, tm)


@pytest.mark.parametrize("family", ["lstm", "portfolio"])
def test_greedy_evaluate_matches_jax(family, tmp_path):
    """Both orchestrators' ``evaluate()`` from the same weights: the LSTM's
    per-step greedy replay threads its ``(h, c)`` carry, the portfolio's
    its (1, A) state; the final portfolio within 1e-6 relative, the reward
    sum within 1e-3 a tick (tests/test_torch_reference.py's greedy-eval
    tolerances)."""
    from sharetrade_tpu.runtime import Orchestrator as JaxOrchestrator
    from sharetrade_tpu_torch.runtime import Orchestrator

    overrides = BASE + FAMILIES[family]
    prices = _prices(2) if family == "portfolio" else _prices()[0]
    jorch = JaxOrchestrator(JaxConfig().apply_overrides(
        overrides + [f"runtime.checkpoint_dir={tmp_path / 'jax'}"]))
    jorch.send_training_data(prices)
    torch_orch = Orchestrator(FrameworkConfig().apply_overrides(
        overrides + [f"runtime.checkpoint_dir={tmp_path / 'torch'}"]),
        device="cpu")
    torch_orch.send_training_data(prices)
    assert torch_orch.env.num_assets == jorch.env.num_assets
    params = jax.tree.map(np.asarray, jorch.train_state.params)
    torch_orch._ts = torch_orch.train_state.replace(
        params=convert.params_from_jax(params))
    jresult, tresult = jorch.evaluate(), torch_orch.evaluate()
    assert set(tresult) == set(jresult)
    assert tresult["eval_portfolio"] == pytest.approx(
        jresult["eval_portfolio"], rel=1e-6)
    assert tresult["eval_reward_sum"] == pytest.approx(
        jresult["eval_reward_sum"], abs=torch_orch.env.num_steps * 1e-3)
