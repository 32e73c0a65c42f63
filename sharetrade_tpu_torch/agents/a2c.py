"""Advantage actor-critic (n-step, synchronous).

Counterpart of the JAX package's ``agents/a2c.py``: B agents advance
``unroll_len`` steps, then one joint update from the bootstrapped n-step
returns: policy, value and entropy losses.

Random draws: the rollout's Gumbel noise (T, B, A) comes from ``ts.rng``
(the agent's ``draw``), or from ``draws`` (the tests hand in the JAX
package's draws).
"""

from __future__ import annotations

import torch

from sharetrade_tpu_torch.agents.base import (
    Agent, TrainState, build_optimizer, make_init, make_update_fn,
    portfolio_metrics)
from sharetrade_tpu_torch.agents.pg import policy_gradients
from sharetrade_tpu_torch.agents.rollout import (
    collect_rollout, discounted_returns, gumbel_noise,
    normalize_advantages_masked, replay_forward)
from sharetrade_tpu_torch.config import LearnerConfig
from sharetrade_tpu_torch.env.core import TradingEnv
from sharetrade_tpu_torch.models.core import Model
from sharetrade_tpu_torch.precision import FP32


def make_a2c_agent(model: Model, env: TradingEnv, cfg: LearnerConfig, *,
                   num_agents: int = 10, steps_per_chunk: int | None = None,
                   precision=None) -> Agent:
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

        def loss_fn(params):
            logits, values, aux = replay_forward(model, params, traj,
                                                 init_carry, remat=cfg.remat)
            log_probs = torch.log_softmax(logits, dim=-1)
            logp = log_probs.gather(-1, traj.action[..., None])[..., 0]
            adv = (returns - values).detach() * weight
            if cfg.normalize_advantages:
                adv = normalize_advantages_masked(adv, weight, denom)
            policy_loss = -(logp * adv).sum() / denom
            value_loss = (torch.square(values - returns) * weight).sum() / denom
            entropy = -((torch.exp(log_probs) * log_probs).sum(dim=-1)
                        * weight).sum() / denom
            total = (policy_loss + cfg.value_coef * value_loss
                     - cfg.entropy_coef * entropy + cfg.aux_loss_coef * aux)
            return total, torch.stack([policy_loss, value_loss,
                                       entropy]).detach()

        loss, terms, grads = policy_gradients(compute, loss_fn)
        with torch.no_grad():
            params, opt_state, _ = apply_update(grads, ts.opt_state,
                                                ts.params)
        ts = ts.replace(params=params, opt_state=opt_state,
                        updates=ts.updates + 1)
        with torch.no_grad():
            metrics = {
                "loss": loss, "policy_loss": terms[0],
                "value_loss": terms[1], "entropy": terms[2],
                "reward_sum": traj.reward.sum(), "env_steps": ts.env_steps,
                "updates": ts.updates,
                **portfolio_metrics(env, ts.env_state),
            }
        return ts, metrics

    return Agent(name="a2c", init=init, step=step, num_agents=num_agents,
                 steps_per_chunk=unroll, model=model, draw=draw)
