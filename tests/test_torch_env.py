"""The port's trading environment against the JAX package's, on the CPU.

The same price series and the same action sequences (numpy, from a seed)
go through the JAX ``TradingEnv`` (its per-agent functions under
``jax.vmap``) and the port's (a leading batch dimension): observations,
states and rewards must agree exactly — the arithmetic is the same float32
operations in the same order — through infeasible buys (a budget below the
price) and sells (no shares), up to and past nothing: the run stops at the
horizon. ``step_priced`` with the by-cursor price equals ``step``.
"""

import jax
import numpy as np
import pytest
import torch

from sharetrade_tpu.env import trading as jtrading
from sharetrade_tpu_torch.agents.base import batched_reset
from sharetrade_tpu_torch.env import trading as ttrading

WINDOW = 6


def _prices(seed, length):
    rng = np.random.default_rng(seed)
    steps = rng.uniform(-0.05, 0.05, length)
    return (40.0 * np.exp(np.cumsum(steps))).astype(np.float32)


def _envs(prices, budget):
    jenv = jtrading.make_trading_env(prices, window=WINDOW,
                                     initial_budget=budget)
    tenv = ttrading.make_trading_env(prices, window=WINDOW,
                                     initial_budget=budget, device="cpu")
    return jenv, tenv


def _assert_state(tstate, jstate):
    for field in ("t", "budget", "shares", "share_value"):
        np.testing.assert_array_equal(getattr(tstate, field).numpy(),
                                      np.asarray(getattr(jstate, field)),
                                      err_msg=field)


def test_reset_observe_and_constants():
    prices = _prices(0, 30)
    jenv, tenv = _envs(prices, 2400.0)
    assert (tenv.num_steps, tenv.obs_dim, tenv.num_actions) == (
        jenv.num_steps, jenv.obs_dim, jenv.num_actions) == (24, 8, 3)
    _assert_state(tenv.reset(), jenv.reset())
    np.testing.assert_array_equal(tenv.observe(tenv.reset()).numpy(),
                                  np.asarray(jenv.observe(jenv.reset())))
    with pytest.raises(ValueError, match="exceed the window"):
        ttrading.env_from_prices(prices[:WINDOW], window=WINDOW,
                                 device="cpu")


@pytest.mark.parametrize("budget", [2400.0, 60.0])
def test_episode_matches_jax(budget):
    """Eight agents, random actions to the horizon; with a 60 budget most
    buys are infeasible after the first and every agent starts sharesless,
    so early sells are infeasible too (both degrade to Hold)."""
    prices = _prices(1, 40)
    jenv, tenv = _envs(prices, budget)
    agents = 8
    rng = np.random.default_rng(2)
    actions = rng.integers(0, 3, (jenv.num_steps, agents))
    jstate = jax.tree.map(lambda x: np.broadcast_to(x, (agents,)),
                          jenv.reset())
    tstate = batched_reset(tenv, agents)
    jstep = jax.vmap(jenv.step)
    feasible = {"hold": 0, "traded": 0}
    for t in range(jenv.num_steps):
        np.testing.assert_array_equal(
            tenv.observe(tstate).numpy(),
            np.asarray(jax.vmap(jenv.observe)(jstate)))
        a = actions[t]
        jnext, jr = jstep(jstate, a.astype(np.int32))
        tnext, tr = tenv.step(tstate, torch.from_numpy(a))
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
        _assert_state(tnext, jnext)
        moved = np.asarray(jnext.shares) != np.asarray(jstate.shares)
        feasible["traded"] += int(moved.sum())
        feasible["hold"] += int((~moved & (a != ttrading.HOLD)).sum())
        jstate, tstate = jnext, tnext
        np.testing.assert_array_equal(
            tenv.portfolio_value(tstate).numpy(),
            np.asarray(jax.vmap(jenv.portfolio_value)(jstate)))
    assert int(tstate.t[0]) == tenv.num_steps
    # Both kinds of outcome happened: real trades and degraded actions.
    assert feasible["traded"] > 0 and feasible["hold"] > 0


def test_step_priced_equals_step():
    prices = _prices(3, 20)
    _, tenv = _envs(prices, 500.0)
    state = batched_reset(tenv, 4)
    for t in range(tenv.num_steps):
        a = torch.tensor([0, 1, 2, t % 3])
        price = torch.tensor(prices[t + WINDOW])
        s1, r1 = tenv.step(state, a)
        s2, r2 = tenv.step_priced(state, a, price)
        assert torch.equal(r1, r2)
        for x, y in zip(s1.leaves(), s2.leaves()):
            assert torch.equal(x, y)
        state = s1
