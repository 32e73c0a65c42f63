"""REINFORCE (vanilla policy gradient).

Counterpart of the JAX package's ``agents/pg.py``: Monte-Carlo
returns-to-go with a batch-mean baseline over the unroll's active steps,
one update per unroll.

Random draws: the rollout's Gumbel noise (T, B, A) comes from ``ts.rng``
(the agent's ``draw``), or from ``draws`` (the tests hand in the JAX
package's draws).
"""

from __future__ import annotations

import torch

from sharetrade_tpu_torch.agents.base import (
    Agent, TrainState, build_optimizer, make_init, make_update_fn,
    portfolio_metrics)
from sharetrade_tpu_torch.agents.rollout import (
    collect_rollout, discounted_returns, gumbel_noise,
    normalize_advantages_masked, replay_forward)
from sharetrade_tpu_torch.config import ConfigError, LearnerConfig
from sharetrade_tpu_torch.env.core import TradingEnv
from sharetrade_tpu_torch.models.core import Model, tree_leaves, unflatten_like
from sharetrade_tpu_torch.precision import FP32


def policy_gradients(params, loss_fn):
    """``(loss, aux, grads)`` of ``loss_fn(params) -> (loss, aux)`` with
    respect to ``params`` (the compute copy), the grads as a leaf list; a
    leaf the loss does not reach (PG's value head) gets zeros."""
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    with torch.enable_grad():
        loss, aux = loss_fn(unflatten_like(params, leaves))
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss.detach(), aux, [torch.zeros_like(p) if g is None else g
                                for p, g in zip(leaves, grads)]


def make_pg_agent(model: Model, env: TradingEnv, cfg: LearnerConfig, *,
                  num_agents: int = 10, steps_per_chunk: int | None = None,
                  precision=None) -> Agent:
    if cfg.remat:
        raise ConfigError("learner.remat is not yet ported to "
                          "sharetrade_tpu_torch")
    optimizer = build_optimizer(cfg)
    precision = precision or FP32
    apply_update = make_update_fn(optimizer, precision)
    unroll = steps_per_chunk or cfg.unroll_len
    init = make_init(model, env, optimizer, precision, num_agents)

    def draw(ts: TrainState) -> torch.Tensor:
        return gumbel_noise((unroll, num_agents, model.num_actions), ts.rng,
                            model.device)

    def step(ts: TrainState, draws: torch.Tensor | None = None):
        if draws is None:
            draws = draw(ts)
        compute = precision.cast_compute(ts.params)
        ts, traj, bootstrap, init_carry = collect_rollout(
            model, env, ts, unroll, num_agents, params=compute, gumbel=draws)
        with torch.no_grad():
            returns = discounted_returns(traj.reward, traj.active, bootstrap,
                                         cfg.gamma)
            weight = traj.active
            denom = torch.clamp(weight.sum(), min=1.0)
            baseline = (returns * weight).sum() / denom
            adv = (returns - baseline) * weight
            if cfg.normalize_advantages:
                adv = normalize_advantages_masked(adv, weight, denom)

        def loss_fn(params):
            logits, _, aux = replay_forward(model, params, traj, init_carry)
            logp = torch.log_softmax(logits, dim=-1).gather(
                -1, traj.action[..., None])[..., 0]
            return (-(logp * adv).sum() / denom
                    + cfg.aux_loss_coef * aux), None

        loss, _, grads = policy_gradients(compute, loss_fn)
        with torch.no_grad():
            params, opt_state, _ = apply_update(grads, ts.opt_state,
                                                ts.params)
        ts = ts.replace(params=params, opt_state=opt_state,
                        updates=ts.updates + 1)
        with torch.no_grad():
            metrics = {
                "loss": loss, "reward_sum": traj.reward.sum(),
                "return_mean": baseline, "env_steps": ts.env_steps,
                "updates": ts.updates,
                **portfolio_metrics(env, ts.env_state),
            }
        return ts, metrics

    return Agent(name="pg", init=init, step=step, num_agents=num_agents,
                 steps_per_chunk=unroll, model=model, draw=draw)
