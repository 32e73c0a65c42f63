"""The port's multi-asset portfolio env against the JAX package's, on the
CPU, and ``cli train --symbol A,B`` building it.

Prices: numpy-seeded walks, 2 assets (and 3 for one stream), window 6,
budget 150 at prices near 50, so a few buys exhaust the budget and
infeasible buys and sells (no budget, no shares) both occur in the random
action streams. Each stream steps a batch of 7 agents through the whole
episode in both packages (the JAX env vmapped), then one step past the
horizon (the clamped trade price).

Tolerances: observations, cursors, budgets, shares, share values and
rewards equal bit for bit (the same float32 operations in the same order:
the portfolio sums run over 2 or 3 assets, one addition order each); at
A = 1 the portfolio env equals the single-asset env (``env/trading.py``)
bit for bit.
"""

import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sharetrade_tpu.env.portfolio import make_portfolio_env as jax_env
from sharetrade_tpu_torch.config import FrameworkConfig
from sharetrade_tpu_torch.env.portfolio import make_portfolio_env
from sharetrade_tpu_torch.env.trading import make_trading_env
from sharetrade_tpu_torch.runtime.orchestrator import Orchestrator
from sharetrade_tpu_torch.serve.driver import SessionSim

REPO = pathlib.Path(__file__).resolve().parents[1]
WINDOW, AGENTS, BUDGET = 6, 7, 150.0


def _prices(assets, length=30, seed=0):
    rng = np.random.default_rng(seed)
    steps = rng.uniform(0.01, 0.05, (assets, length)) * rng.choice(
        [-1.0, 1.0], (assets, length))
    return (50.0 * np.exp(np.cumsum(steps, axis=1))).astype(np.float32)


def _batch(state, n):
    return state.map(lambda x: x.expand((n,) + x.shape))


def _assert_state(t_state, j_state):
    for f in ("t", "budget", "shares", "share_value"):
        np.testing.assert_array_equal(getattr(t_state, f).numpy(),
                                      np.asarray(getattr(j_state, f)),
                                      err_msg=f)


@pytest.mark.parametrize("assets,seed", [(2, 0), (2, 1), (3, 2)])
def test_random_action_streams_match_jax(assets, seed):
    prices = _prices(assets, seed=seed)
    jenv = jax_env(prices, window=WINDOW, initial_budget=BUDGET)
    tenv = make_portfolio_env(prices, window=WINDOW, initial_budget=BUDGET,
                              device="cpu")
    assert (tenv.obs_dim, tenv.num_actions, tenv.num_assets,
            tenv.num_steps) == (jenv.obs_dim, jenv.num_actions,
                                jenv.num_assets, jenv.num_steps)
    assert tenv.step_priced is None
    rng = np.random.default_rng(seed + 10)
    jstate = jax.tree.map(lambda x: jnp.broadcast_to(x, (AGENTS,) + x.shape),
                          jenv.reset())
    tstate = _batch(tenv.reset(), AGENTS)
    jstep, jobs = jax.jit(jax.vmap(jenv.step)), jax.jit(jax.vmap(
        jenv.observe))
    infeasible = 0
    for _ in range(jenv.num_steps + 1):
        np.testing.assert_array_equal(tenv.observe(tstate).numpy(),
                                      np.asarray(jobs(jstate)))
        # Buys weighted up so the budget runs out; every action appears.
        actions = rng.choice(jenv.num_actions, AGENTS,
                             p=np.r_[np.full(assets, 0.6 / assets),
                                     np.full(assets, 0.3 / assets), 0.1])
        jstate2, jr = jstep(jstate, jnp.asarray(actions, jnp.int32))
        tstate2, tr = tenv.step(tstate, torch.from_numpy(actions))
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
        _assert_state(tstate2, jstate2)
        np.testing.assert_array_equal(
            tenv.portfolio_value(tstate2).numpy(),
            np.asarray(jax.vmap(jenv.portfolio_value)(jstate2)))
        moved = np.abs(np.asarray(jstate2.shares - jstate.shares)).sum(-1)
        infeasible += int(((actions < 2 * assets) & (moved == 0)).sum())
        jstate, tstate = jstate2, tstate2
    assert infeasible > 0


def test_one_asset_equals_the_trading_env():
    prices = _prices(1, seed=5)
    penv = make_portfolio_env(prices, window=WINDOW, initial_budget=BUDGET,
                              device="cpu")
    tenv = make_trading_env(prices[0], window=WINDOW, initial_budget=BUDGET,
                            device="cpu")
    assert (penv.obs_dim, penv.num_actions) == (tenv.obs_dim,
                                                tenv.num_actions)
    rng = np.random.default_rng(3)
    ps, ts = _batch(penv.reset(), AGENTS), _batch(tenv.reset(), AGENTS)
    for _ in range(tenv.num_steps):
        assert torch.equal(penv.observe(ps), tenv.observe(ts))
        a = torch.from_numpy(rng.integers(0, 3, AGENTS))
        ps, pr = penv.step(ps, a)
        ts, tr = tenv.step(ts, a)
        assert torch.equal(pr, tr)
        assert torch.equal(ps.budget, ts.budget)
        assert torch.equal(ps.shares[:, 0], ts.shares)
        assert torch.equal(ps.share_value[:, 0], ts.share_value)
        assert torch.equal(penv.portfolio_value(ps), tenv.portfolio_value(ts))


@pytest.mark.parametrize("assets,seed", [(1, 6), (2, 7), (3, 8)])
def test_serving_sessions_trade_by_the_env_rules(assets, seed):
    """``serve/driver.SessionSim``, the serving traffic of the families
    (over an (A, T) matrix for the portfolio, over the series itself at
    A = 1), steps as the port's portfolio env on the same random action
    stream from the same start, infeasible trades included, then restarts
    at the series' end from its start with a fresh portfolio under a new
    session id. Observations and shares bit for bit (both keep the budget
    in float32)."""
    prices, start = _prices(assets, seed=seed), 3
    env = make_portfolio_env(prices, window=WINDOW, initial_budget=BUDGET,
                             device="cpu")
    sess = SessionSim("u", prices if assets > 1 else prices[0], WINDOW,
                      start, budget=BUDGET)
    first = env.reset().replace(t=torch.tensor(start, dtype=torch.int32))
    state, rng, infeasible = first, np.random.default_rng(seed), 0
    for _ in range(env.num_steps - start):
        assert sess.sid == "u"
        np.testing.assert_array_equal(sess.observation(),
                                      env.observe(state).numpy())
        np.testing.assert_array_equal(sess.shares, state.shares.numpy())
        action = int(rng.choice(env.num_actions, p=np.r_[
            np.full(assets, 0.6 / assets), np.full(assets, 0.3 / assets),
            0.1]))
        moved, state = state, env.step(state, torch.tensor(action))[0]
        infeasible += bool(action < 2 * assets
                           and torch.equal(moved.shares, state.shares))
        sess.advance(action)
    assert infeasible > 0
    assert sess.sid == "u#1" and sess.t == 0
    np.testing.assert_array_equal(sess.observation(),
                                  env.observe(first).numpy())


def test_orchestrator_builds_the_portfolio_env(tmp_path):
    cfg = FrameworkConfig().apply_overrides([
        "learner.algo=ppo", "model.kind=transformer", "model.num_heads=2",
        "model.head_dim=16", f"env.window={WINDOW}",
        "parallel.num_workers=4", "runtime.chunk_steps=8",
        f"runtime.checkpoint_dir={tmp_path / 'ckpts'}"])
    orch = Orchestrator(cfg, device="cpu")
    orch.send_training_data(_prices(2))
    assert orch.env.num_assets == 2 and orch.env.num_actions == 5
    assert orch.agent.model.obs_dim == 2 * WINDOW + 3
    assert orch.agent.model.num_actions == 5


def test_cli_train_with_two_symbols(tmp_path):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    cmd = [sys.executable, "-m", "sharetrade_tpu_torch.cli", "train",
           "--device", "cpu", "--symbol", "MSFT,AAPL"]
    for item in ["learner.algo=ppo", "model.kind=transformer",
                 "model.num_heads=2", "model.head_dim=16", "env.window=12",
                 "parallel.num_workers=4", "runtime.chunk_steps=16",
                 "learner.ppo_epochs=1", "data.synthetic_length=44"]:
        cmd += ["--set", item]
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=180,
                         cwd=tmp_path, env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "prices for 2 assets ['MSFT', 'AAPL']" in out.stderr
    assert "loaded (2, 44) prices" in out.stderr
    summary = json.loads(out.stdout.strip().splitlines()[-1])
    assert summary["env_steps"] == 32 and np.isfinite(
        summary["avg_portfolio"])
