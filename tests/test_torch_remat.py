"""Rematerialisation: ``model.remat_blocks`` and ``learner.remat``.

Checkpointing changes what the backward keeps, never what it computes:

- ``remat_blocks`` on against off on the episode transformer (dense FFN
  and MoE top-2): ``apply_unroll`` and ``apply_unroll_shared`` outputs and
  every parameter gradient of a scalar loss of them;
- ``learner.remat`` on against off, one chunk from the same seed: PPO on
  the episode transformer (the shared replay), on the window transformer
  with B x T above 2,048 rows (two fold groups) and on the LSTM (the
  recurrent replay, one checkpoint a step); A2C on the LSTM and PG on the
  MLP (their models in tests/test_torch_families_ppo.py and
  tests/test_torch_reference.py);
- one chunk with both knobs on against the JAX package's, the JAX step's
  own draws handed in;
- the checkpoint is live: under ``torch.autograd.graph.saved_tensors_hooks``
  the bytes the replay forward saves for the backward with remat are under
  half of those without (on the CPU the numbers do not move, so this is
  the only trace of it here).

Tolerances: the JAX package's own (``tests/test_models.py``
``test_remat_blocks_matches_exact``): outputs and gradients within rtol
5e-5 and atol 1e-5 (bit-equal is expected on the CPU: the recompute runs
the same kernels on the same inputs); the chunk against the JAX package's
as tests/test_torch_ppo.py holds it (params 1e-5, metrics 1e-4 + 1e-4
relative).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sharetrade_tpu.agents import build_agent as jax_build_agent
from sharetrade_tpu.config import FrameworkConfig as JaxConfig
from sharetrade_tpu.env import trading as jtrading
from sharetrade_tpu_torch import convert
from sharetrade_tpu_torch.agents import build_agent
from sharetrade_tpu_torch.agents.ppo import Draws
from sharetrade_tpu_torch.agents.base import state_items
from sharetrade_tpu_torch.agents.rollout import (
    collect_rollout, replay_forward)
from sharetrade_tpu_torch.config import FrameworkConfig
from sharetrade_tpu_torch.env.trading import make_trading_env
from sharetrade_tpu_torch.models.core import tree_leaves, unflatten_like
from sharetrade_tpu_torch.models.transformer_episode import (
    episode_transformer_policy)

RTOL, ATOL = 5e-5, 1e-5
WINDOW = 12
EPISODE = ["model.kind=transformer", "model.seq_mode=episode",
           "model.num_layers=2", "model.num_heads=2", "model.head_dim=16"]
WINDOW_TR = ["model.kind=transformer", "model.num_layers=2",
             "model.num_heads=2", "model.head_dim=16"]


def _prices(length):
    rng = np.random.default_rng(0)
    steps = rng.uniform(0.01, 0.03, length) * rng.choice([-1.0, 1.0], length)
    return (50.0 * np.exp(np.cumsum(steps))).astype(np.float32)


def _close(got, want, msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=RTOL,
                               atol=ATOL, err_msg=msg)


def _episode_case(moe):
    """(model, remat model, params, trajectory, init carry): one rollout of
    4 agents over 8 steps."""
    kw = dict(num_layers=2, num_heads=2, head_dim=16, device="cpu")
    if moe:
        kw.update(moe_experts=4, moe_top_k=2, moe_capacity_factor=0.5)
    cfg = FrameworkConfig().apply_overrides(
        ["learner.algo=ppo", *EPISODE, f"env.window={WINDOW}",
         "parallel.num_workers=4"])
    env = make_trading_env(_prices(60), window=WINDOW, device="cpu")
    model = episode_transformer_policy(WINDOW + 2, 3, **kw)
    remat = episode_transformer_policy(WINDOW + 2, 3, remat_blocks=True, **kw)
    agent = build_agent(cfg, env, model, device="cpu")
    ts = agent.init(0)
    _, traj, _, init_carry = collect_rollout(model, env, ts, 8, 4)
    return model, remat, ts.params, traj, init_carry


def _grads(fwd, params, traj, carry):
    leaves = [p.detach().clone().requires_grad_() for p in tree_leaves(params)]
    logits, values, aux = fwd(unflatten_like(params, leaves), traj.obs, carry)
    loss = (torch.log_softmax(logits, -1)[..., 0].sum()
            + values.square().sum() + aux)
    return (logits.detach(), values.detach(), aux.detach(),
            torch.autograd.grad(loss, leaves))


@pytest.mark.parametrize("moe", [False, True], ids=["dense", "moe_top2"])
@pytest.mark.parametrize("entry", ["apply_unroll", "apply_unroll_shared"])
def test_remat_blocks_matches_exact(entry, moe):
    model, remat, params, traj, carry = _episode_case(moe)
    got = _grads(getattr(remat, entry), params, traj, carry)
    want = _grads(getattr(model, entry), params, traj, carry)
    for name, g, w in zip(("logits", "values", "aux"), got[:3], want[:3]):
        _close(g, w, name)
    assert len(got[3]) == len(want[3]) == len(tree_leaves(params))
    for i, (g, w) in enumerate(zip(got[3], want[3])):
        _close(g, w, f"grad leaf {i}")


CASES = {
    "ppo_episode": ["learner.algo=ppo", *EPISODE, "parallel.num_workers=4",
                    "runtime.chunk_steps=8"],
    # 520 agents a minibatch x 4 steps = 2,080 rows: two fold groups of 2.
    "ppo_window_two_groups": ["learner.algo=ppo", *WINDOW_TR,
                              "parallel.num_workers=520",
                              "runtime.chunk_steps=4",
                              "learner.ppo_epochs=1",
                              "learner.ppo_minibatches=1"],
    "ppo_lstm": ["learner.algo=ppo", "model.kind=lstm", "model.hidden_dim=16",
                 "parallel.num_workers=4", "runtime.chunk_steps=8"],
    "a2c_lstm": ["learner.algo=a2c", "model.kind=lstm", "model.hidden_dim=16",
                 "parallel.num_workers=4", "runtime.chunk_steps=8"],
    "pg_mlp": ["learner.algo=pg", "model.kind=mlp", "model.hidden_dim=16",
               "parallel.num_workers=4", "runtime.chunk_steps=8"],
}


def _chunk(overrides, remat):
    cfg = FrameworkConfig().apply_overrides(
        overrides + [f"env.window={WINDOW}",
                     f"learner.remat={str(remat).lower()}"])
    assert cfg.learner.remat is remat
    steps = cfg.runtime.chunk_steps
    env = make_trading_env(_prices(WINDOW + steps + 4), window=WINDOW,
                           device="cpu")
    agent = build_agent(cfg, env, device="cpu")
    ts, metrics = agent.step(agent.init(0))
    return ts, metrics


@pytest.mark.parametrize("case", list(CASES))
def test_learner_remat_matches_exact(case):
    ts_r, m_r = _chunk(CASES[case], True)
    ts_e, m_e = _chunk(CASES[case], False)
    items_r, items_e = state_items(ts_r), state_items(ts_e)
    assert [p for p, _ in items_r] == [p for p, _ in items_e]
    for (path, a), (_, b) in zip(items_r, items_e):
        _close(a.float(), b.float(), path)
    assert set(m_r) == set(m_e)
    for key in m_e:
        _close(m_r[key], m_e[key], key)


def test_remat_chunk_matches_jax():
    """PPO on the episode transformer with ``learner.remat`` and
    ``model.remat_blocks`` on, one chunk of both packages."""
    agents, unroll = 4, 8
    overrides = ["learner.algo=ppo", *EPISODE, f"env.window={WINDOW}",
                 f"parallel.num_workers={agents}",
                 f"runtime.chunk_steps={unroll}", "learner.ppo_epochs=2",
                 "learner.ppo_minibatches=2", "learner.remat=true",
                 "model.remat_blocks=true"]
    prices = _prices(60)
    jagent = jax_build_agent(JaxConfig().apply_overrides(overrides),
                             jtrading.make_trading_env(prices, window=WINDOW))
    tagent = build_agent(FrameworkConfig().apply_overrides(overrides),
                         make_trading_env(prices, window=WINDOW,
                                          device="cpu"), device="cpu")
    jts = jagent.init(jax.random.PRNGKey(3))
    tts = convert.train_state_from_jax(jax.tree.map(np.asarray, jts))
    rng, k_noise = jax.random.split(jts.rng)
    gumbel = jax.random.gumbel(k_noise, (unroll, agents, 3), jnp.float32)
    perms = []
    for _ in range(2):
        rng, k_perm = jax.random.split(rng)
        perms.append(np.asarray(jax.random.permutation(k_perm, agents)))
    jts2, jm = jax.jit(jagent.step)(jts)
    tts2, tm = tagent.step(tts, draws=Draws(torch.tensor(np.asarray(gumbel)),
                                            torch.tensor(np.stack(perms))))
    t = convert.train_state_to_numpy(tts2)
    np.testing.assert_array_equal(t["env_state"]["budget"],
                                  np.asarray(jts2.env_state.budget))
    jflat = convert.flatten(jax.tree.map(np.asarray, jts2.params))
    tflat = convert.flatten(t["params"])
    assert sorted(jflat) == sorted(tflat)
    for k in jflat:
        np.testing.assert_allclose(tflat[k], jflat[k], atol=1e-5, rtol=0,
                                   err_msg=k)
    for key in jm:
        np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                   rtol=1e-4, atol=1e-4, err_msg=key)


def _saved_bytes(fn) -> int:
    """Bytes of the tensors autograd saves for the backward while ``fn``
    runs (every pack counted, views at their own size)."""
    total = [0]

    def pack(x):
        total[0] += x.numel() * x.element_size()
        return x

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda x: x):
        fn()
    return total[0]


@pytest.mark.parametrize("case", ["ppo_episode", "ppo_window_two_groups",
                                  "ppo_lstm", "remat_blocks"])
def test_checkpoint_is_live(case):
    """The replay forward of one minibatch saves under half the bytes with
    remat than without."""
    overrides = CASES["ppo_episode" if case == "remat_blocks" else case]
    saved = {}
    for remat in (False, True):
        knob = ("model.remat_blocks" if case == "remat_blocks"
                else "learner.remat") + f"={str(remat).lower()}"
        cfg = FrameworkConfig().apply_overrides(
            overrides + [f"env.window={WINDOW}", knob])
        steps = cfg.runtime.chunk_steps
        env = make_trading_env(_prices(WINDOW + steps + 4), window=WINDOW,
                               device="cpu")
        agent = build_agent(cfg, env, device="cpu")
        ts = agent.init(0)
        _, traj, _, carry = collect_rollout(agent.model, env, ts, steps,
                                            cfg.parallel.num_workers)
        leaves = [p.detach().requires_grad_()
                  for p in tree_leaves(ts.params)]
        params = unflatten_like(ts.params, leaves)
        saved[remat] = _saved_bytes(lambda: replay_forward(
            agent.model, params, traj, carry,
            remat=cfg.learner.remat)[0].sum())
    assert saved[True] < saved[False] / 2, saved
