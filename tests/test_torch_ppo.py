"""The training slice as a whole: one PPO step of the port against the JAX
package's, on the CPU.

The JAX agent (``make_ppo_agent`` through ``build_agent``) is initialised
from a seed and its ``TrainState`` converted to the port's
(``convert.train_state_from_jax``); the JAX step is jitted once per module.
The port's step receives the JAX step's own random draws through
``draws=``: the rollout's Gumbel noise (``split(ts.rng) -> (rng,
k_noise)``) and one permutation per epoch (``split(rng) -> (rng,
k_perm)``), in the JAX package's split order. Size: 8 agents, unroll 16,
L 2, H 2, Dh 16, window 12, 2 epochs x 2 minibatches, adagrad.

Tolerances:
- fp32, two chunks: actions, rewards, env states and counters equal; the
  params within 1e-5, the carry's K/V within 1e-4 (entries up to ~6, as
  tests/test_torch_episode_model.py states); the adagrad sums of squared gradients
  within 1e-3 relative (gradients up to ~1e3, the value loss's scale, are
  differences of reductions taken in another order: up to ~1.5e-4
  relative apart, twice that once squared); the chunk metrics within 1e-4
  relative (sums over agents in another order);
- GAE and the masked normalisation alone: 1e-5 absolute;
- bf16_mixed, one minibatch's loss and gradients from one converted
  trajectory: loss terms within 1% and gradients within 5% in relative L2
  (bf16 rounds every activation; the libraries round at different points).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sharetrade_tpu.agents import build_agent as jax_build_agent
from sharetrade_tpu.agents import rollout as jrollout
from sharetrade_tpu.config import FrameworkConfig as JaxConfig
from sharetrade_tpu.env import trading as jtrading
from sharetrade_tpu_torch import convert
from sharetrade_tpu_torch.agents import build_agent
from sharetrade_tpu_torch.agents import rollout as trollout
from sharetrade_tpu_torch.agents.ppo import Draws
from sharetrade_tpu_torch.config import FrameworkConfig
from sharetrade_tpu_torch.env.trading import make_trading_env

AGENTS, UNROLL, EPOCHS, WINDOW = 8, 16, 2, 12
OVERRIDES = [
    "learner.algo=ppo", "model.kind=transformer", "model.seq_mode=episode",
    "model.num_layers=2", "model.num_heads=2", "model.head_dim=16",
    f"env.window={WINDOW}", f"parallel.num_workers={AGENTS}",
    f"runtime.chunk_steps={UNROLL}", f"learner.ppo_epochs={EPOCHS}",
    "learner.ppo_minibatches=2",
]


def _prices():
    rng = np.random.default_rng(0)
    steps = rng.uniform(0.01, 0.03, 80) * rng.choice([-1.0, 1.0], 80)
    return (50.0 * np.exp(np.cumsum(steps))).astype(np.float32)


class _Pair:
    def __init__(self, mode):
        prices = _prices()
        overrides = OVERRIDES + [f"precision.mode={mode}"]
        self.jagent = jax_build_agent(
            JaxConfig().apply_overrides(overrides),
            jtrading.make_trading_env(prices, window=WINDOW))
        self.tagent = build_agent(
            FrameworkConfig().apply_overrides(overrides),
            make_trading_env(prices, window=WINDOW, device="cpu"),
            device="cpu")
        self.jts = self.jagent.init(jax.random.PRNGKey(3))
        self.tts = convert.train_state_from_jax(
            jax.tree.map(np.asarray, self.jts))


def _draws(rng_key):
    """The JAX step's own draws, in its split order."""
    rng, k_noise = jax.random.split(rng_key)
    gumbel = jax.random.gumbel(k_noise, (UNROLL, AGENTS, 3), jnp.float32)
    perms = []
    for _ in range(EPOCHS):
        rng, k_perm = jax.random.split(rng)
        perms.append(jax.random.permutation(k_perm, AGENTS))
    return Draws(torch.tensor(np.asarray(gumbel)),
                 torch.tensor(np.stack(perms)))


@pytest.fixture(scope="module")
def fp32_chunks():
    """Two chunks of both packages from the same converted state."""
    pair = _Pair("fp32")
    jstep = jax.jit(pair.jagent.step)
    jts, tts, rows = pair.jts, pair.tts, []
    for _ in range(2):
        draws = _draws(jts.rng)
        jts, jm = jstep(jts)
        tts, tm = pair.tagent.step(tts, draws=draws)
        # A snapshot: the port updates params and moments in place.
        rows.append((jax.tree.map(np.asarray, jts), jm,
                     convert.train_state_to_numpy(tts), tm))
    return rows


def test_fp32_states_match(fp32_chunks):
    for jts, _, t, _ in fp32_chunks:
        for field in ("t", "budget", "shares", "share_value"):
            np.testing.assert_array_equal(
                t["env_state"][field], getattr(jts.env_state, field),
                err_msg=field)
        assert int(t["env_steps"]) == int(jts.env_steps)
        assert int(t["updates"]) == int(jts.updates)
        for got, want in zip(jax.tree.leaves(t["params"]),
                             jax.tree.leaves(jts.params)):
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
        for got, want in zip(
                jax.tree.leaves(t["opt_state"][0].sum_of_squares),
                jax.tree.leaves(jts.opt_state[0].sum_of_squares)):
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-3)
        for key in ("k", "v"):
            np.testing.assert_allclose(t["carry"][key], jts.carry[key],
                                       atol=1e-4, rtol=0)
        for key in ("hist", "t"):
            np.testing.assert_array_equal(t["carry"][key], jts.carry[key])


def test_fp32_metrics_match(fp32_chunks):
    for _, jm, _, tm in fp32_chunks:
        assert set(tm) == set(jm)
        for key in jm:
            want = float(jm[key])
            assert np.isfinite(float(tm[key]))
            np.testing.assert_allclose(float(tm[key]), want, rtol=1e-4,
                                       atol=1e-4, err_msg=key)
    assert float(fp32_chunks[-1][3]["env_steps"]) == 2 * UNROLL


def test_gae_and_normalisation_alone():
    rng = np.random.default_rng(4)
    rewards = rng.standard_normal((12, 5)).astype(np.float32)
    values = rng.standard_normal((12, 5)).astype(np.float32)
    active = (rng.uniform(size=(12, 5)) > 0.2).astype(np.float32)
    boot = rng.standard_normal(5).astype(np.float32) * active[-1]
    want = jrollout.gae_advantages(rewards, values, active, boot, 0.9, 0.95)
    got = trollout.gae_advantages(*map(torch.from_numpy,
                                       (rewards, values, active, boot)),
                                  0.9, 0.95)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    denom = max(active.sum(), 1.0)
    want_n = jrollout.normalize_advantages_masked(
        np.asarray(want), active, jnp.float32(denom))
    got_n = trollout.normalize_advantages_masked(
        got, torch.from_numpy(active), torch.tensor(denom))
    np.testing.assert_allclose(got_n.numpy(), np.asarray(want_n), atol=1e-5)


def test_bf16_minibatch_loss_and_grads():
    """One trajectory from the converted state (the port's rollout, fed the
    JAX draws), then minibatch 0's loss and gradients in both packages."""
    pair = _Pair("bf16_mixed")
    draws = _draws(pair.jts.rng)
    cfg = FrameworkConfig().apply_overrides(OVERRIDES)
    from sharetrade_tpu_torch.precision import PrecisionPolicy
    policy = PrecisionPolicy(mode="bf16_mixed")
    ts, traj, boot, init_carry = trollout.collect_rollout(
        pair.tagent.model,
        make_trading_env(_prices(), window=WINDOW, device="cpu"),
        pair.tts, UNROLL, AGENTS, params=policy.cast_compute(pair.tts.params),
        gumbel=draws.gumbel)
    adv = trollout.gae_advantages(traj.reward, traj.value, traj.active, boot,
                                  cfg.learner.gamma, cfg.learner.gae_lambda)
    ret = adv + traj.value
    idx = torch.arange(AGENTS // 2)
    carry_mb = {k: v.index_select(0, idx) for k, v in init_carry.items()}
    terms, grads = pair.tagent.minibatch_grads(
        policy.cast_compute(pair.tts.params), traj.take(idx), carry_mb,
        adv.index_select(1, idx), ret.index_select(1, idx))

    from sharetrade_tpu.agents.rollout import StepData
    from sharetrade_tpu.precision import PrecisionPolicy as JaxPolicy

    def jax_traj(x):
        return jnp.asarray(convert.params_to_numpy(x.index_select(1, idx)))

    jtraj = StepData(obs=jax_traj(traj.obs),
                     action=jax_traj(traj.action).astype(jnp.int32),
                     logp=jax_traj(traj.logp), value=jax_traj(traj.value),
                     reward=jax_traj(traj.reward),
                     active=jax_traj(traj.active))
    jcarry = jax.tree.map(lambda x: x[:AGENTS // 2], pair.jts.carry)
    jparams = JaxPolicy(mode="bf16_mixed").cast_compute(pair.jts.params)
    model = pair.jagent.model
    lc = cfg.learner

    def jloss(p):
        logits, values, _ = jrollout.replay_forward(model, p, jtraj, jcarry)
        log_probs = jax.nn.log_softmax(logits)
        logp = jnp.take_along_axis(log_probs, jtraj.action[..., None],
                                   axis=-1)[..., 0]
        w = jtraj.active
        denom = jnp.maximum(jnp.sum(w), 1.0)
        a = jrollout.normalize_advantages_masked(
            jax_traj(adv), w, denom)
        ratio = jnp.exp(logp - jtraj.logp)
        clipped = jnp.clip(ratio, 1.0 - lc.clip_eps, 1.0 + lc.clip_eps)
        pl = -jnp.sum(jnp.minimum(ratio * a, clipped * a) * w) / denom
        vl = jnp.sum(jnp.square(values - jax_traj(ret)) * w) / denom
        ent = -jnp.sum(jnp.sum(jnp.exp(log_probs) * log_probs, -1) * w) / denom
        return pl + lc.value_coef * vl - lc.entropy_coef * ent, (pl, vl, ent)

    (jtotal, jaux), jgrads = jax.jit(jax.value_and_grad(
        jloss, has_aux=True))(jparams)
    want_terms = np.array([float(jtotal), *map(float, jaux)])
    np.testing.assert_allclose(terms.numpy(), want_terms, rtol=1e-2,
                               atol=1e-4)
    got = np.concatenate([g.float().numpy().ravel() for g in grads])
    want = np.concatenate([np.asarray(g, np.float32).ravel()
                           for g in jax.tree.leaves(jgrads)])
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel < 5e-2, rel
