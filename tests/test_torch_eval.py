"""Greedy evaluation of the port held against the JAX package's, on the CPU.

The same params go through both packages' ``greedy_rollout_precomputed``
and both orchestrators' ``evaluate()`` / ``evaluate_best()``. Size: the
small episode-PPO config (L 2, H 2, Dh 16, window 12), fp32, a 64-tick
horizon over a seeded random-walk series.

The params are the JAX init with every dense layer redrawn from a numpy
seed: He-scale weights, zero biases, and the price embedding scaled by 30,
so that the log returns (0.01 to 0.03) and not the biases drive the trunk.
With the init's own weights the greedy policy takes one action for the
whole episode, which would leave the trade price, the head row and the
argmax untested. The test asserts that the policy it replays takes each
of the three actions several times.

Tolerances: the final cursor and shares are equal; the per-tick rewards
within 1e-3 (portfolio values near 2,400, whose fp32 ulp is 2.4e-4,
reduced in another order); the final budget and share value, and the eval
portfolio, within 1e-6 relative; the reward sum within 64 times the
per-tick tolerance.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sharetrade_tpu.agents import rollout as jrollout
from sharetrade_tpu.config import FrameworkConfig as JaxConfig
from sharetrade_tpu.runtime import Orchestrator as JaxOrchestrator
from sharetrade_tpu_torch import convert
from sharetrade_tpu_torch.agents import rollout as trollout
from sharetrade_tpu_torch.config import FrameworkConfig
from sharetrade_tpu_torch.runtime import Orchestrator

WINDOW, HORIZON, PARAMS_SEED = 12, 64, 19
REWARD_ATOL = 1e-3
OVERRIDES = ["learner.algo=ppo", "model.kind=transformer",
             "model.seq_mode=episode", "model.num_layers=2",
             "model.num_heads=2", "model.head_dim=16", f"env.window={WINDOW}",
             "parallel.num_workers=4", "runtime.chunk_steps=16",
             "precision.mode=fp32"]


def _prices():
    rng = np.random.default_rng(0)
    steps = (rng.uniform(0.01, 0.03, WINDOW + HORIZON)
             * rng.choice([-1.0, 1.0], WINDOW + HORIZON))
    return (50.0 * np.exp(np.cumsum(steps))).astype(np.float32)


def _trading_params(jparams):
    """The JAX init's tree with every dense layer redrawn (see the module
    docstring), as numpy leaves."""
    rng = np.random.default_rng(PARAMS_SEED)
    flat = convert.flatten(jax.tree.map(np.asarray, jparams))
    for name, leaf in flat.items():
        if name.endswith(".w"):
            scale = 30.0 if name == "embed.w" else 1.0
            flat[name] = (rng.standard_normal(leaf.shape) * scale
                          / np.sqrt(leaf.shape[0])).astype(np.float32)
        elif name.endswith(".b"):
            flat[name] = np.zeros_like(leaf)
    return convert.unflatten(flat)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """Both orchestrators on the same series, holding the same params."""
    root = tmp_path_factory.mktemp("eval")
    prices = _prices()
    jorch = JaxOrchestrator(JaxConfig().apply_overrides(
        OVERRIDES + [f"runtime.checkpoint_dir={root / 'jax'}"]))
    jorch.send_training_data(prices)
    torch_orch = Orchestrator(FrameworkConfig().apply_overrides(
        OVERRIDES + [f"runtime.checkpoint_dir={root / 'torch'}"]),
        device="cpu")
    torch_orch.send_training_data(prices)
    params = _trading_params(jorch.train_state.params)
    jorch._ts = jorch.train_state.replace(
        params=jax.tree.map(jnp.asarray, params))
    torch_orch._ts = convert.train_state_from_jax(
        jax.tree.map(np.asarray, jorch.train_state))
    return jorch, torch_orch


def test_greedy_rollout_matches_jax(pair):
    jorch, torch_orch = pair
    env = torch_orch.env
    actions = []

    def spy(state, action, price):
        actions.append(int(action[0]))
        return env.step_priced(state, action, price)

    jfinal, jrewards = jax.jit(
        lambda p: jrollout.greedy_rollout_precomputed(
            jorch.agent.model, jorch.env, p))(jorch.train_state.params)
    tfinal, trewards = trollout.greedy_rollout_precomputed(
        torch_orch.agent.model, dataclasses.replace(env, step_priced=spy),
        torch_orch.train_state.params)

    assert len(actions) == HORIZON
    assert np.bincount(actions, minlength=3).min() >= 5, actions
    np.testing.assert_allclose(trewards.numpy(), np.asarray(jrewards),
                               rtol=0, atol=REWARD_ATOL)
    assert int(tfinal.t[0]) == int(jfinal.t) == HORIZON
    assert float(tfinal.shares[0]) == float(jfinal.shares)
    for field in ("budget", "share_value"):
        np.testing.assert_allclose(
            getattr(tfinal, field).numpy()[0],
            np.asarray(getattr(jfinal, field)), rtol=1e-6, err_msg=field)


def test_evaluate_and_tag_best_match_jax(pair):
    jorch, torch_orch = pair
    jresult, tresult = jorch.evaluate(), torch_orch.evaluate()
    assert set(tresult) == set(jresult) == {"eval_portfolio",
                                            "eval_reward_sum"}
    assert tresult["eval_portfolio"] == pytest.approx(
        jresult["eval_portfolio"], rel=1e-6)
    assert tresult["eval_reward_sum"] == pytest.approx(
        jresult["eval_reward_sum"], abs=HORIZON * REWARD_ATOL)
    # The first evaluation beats the empty bar: both retain tag_best.
    jmeta = jorch.checkpoints.tagged_metadata("best")
    tmeta = torch_orch.checkpoints.tagged_metadata("best")
    assert tmeta["updates"] == jmeta["updates"] == 0
    assert tmeta["eval_portfolio"] == tresult["eval_portfolio"]
    jbest, tbest = jorch.evaluate_best(), torch_orch.evaluate_best()
    assert tbest == {**tresult, "eval_updates": 0.0}
    assert tbest["eval_portfolio"] == pytest.approx(
        jbest["eval_portfolio"], rel=1e-6)
    assert tbest["eval_updates"] == jbest["eval_updates"]
