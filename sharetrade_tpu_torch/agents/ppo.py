"""PPO with GAE.

Counterpart of the JAX package's ``agents/ppo.py``: a clipped surrogate
objective over ``ppo_epochs`` epochs of ``ppo_minibatches`` minibatch
updates per chunk. Minibatches cut the agent axis, never time, so each
replays whole sequences from the unroll's initial carry.

Per chunk: the rollout reads ONE compute-dtype copy of the masters; GAE
runs on the trajectory; then per epoch one permutation of the agents, and
per minibatch the loss and its gradients with respect to the compute copy
of the current masters (bf16 under ``bf16_mixed``), and the fused optimizer
update of the float32 masters in place. That update also writes the next
compute copy (the JAX package re-casts the masters at the top of each
minibatch: the same values), so the first minibatch reuses the rollout's
copy and no minibatch casts.

Random draws: the rollout's Gumbel noise (T, B, A) and the epochs'
permutations (epochs, B) come from ``ts.rng`` in that order (the agent's
``draw``), or from ``draws`` (the tests hand in the JAX package's draws,
which a torch generator cannot reproduce).

``step(ts, marker=f)`` calls ``f(name)`` as each part of the chunk has been
enqueued — ``trunk``, ``rollout_loop``, ``gae``, then per minibatch
``replay_fwd``, ``replay_bwd``, ``update`` — so a caller can place a CUDA
event there (``chip_smoke.py``'s chunk breakdown); no marker, no cost.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from sharetrade_tpu_torch.agents.base import (
    Agent, TrainState, build_optimizer, make_init, make_update_fn,
    portfolio_metrics)
from sharetrade_tpu_torch.agents.rollout import (
    collect_rollout, gae_advantages, gumbel_noise,
    normalize_advantages_masked, replay_forward)
from sharetrade_tpu_torch.config import ConfigError, LearnerConfig
from sharetrade_tpu_torch.env.core import TradingEnv
from sharetrade_tpu_torch.models.core import (
    Model, tree_leaves, tree_map, unflatten_like)
from sharetrade_tpu_torch.precision import FP32
from sharetrade_tpu_torch.utils.logging import get_logger


class Draws(NamedTuple):
    """Pre-drawn randomness for one PPO step."""

    gumbel: torch.Tensor   # (T, B, A) float32 sampling noise
    perms: torch.Tensor    # (epochs, B) agent permutations


def num_minibatches(cfg: LearnerConfig, num_agents: int) -> int:
    """The largest divisor of ``num_agents`` not above the configured count
    (10 agents / 4 requested -> 2 minibatches of 5)."""
    requested = max(1, min(cfg.ppo_minibatches, num_agents))
    count = max(d for d in range(1, requested + 1) if num_agents % d == 0)
    if count != requested:
        get_logger("agents.ppo").warning(
            "ppo_minibatches=%d does not divide num_agents=%d; using %d",
            cfg.ppo_minibatches, num_agents, count)
    return count


def make_ppo_agent(model: Model, env: TradingEnv, cfg: LearnerConfig, *,
                   num_agents: int = 10, steps_per_chunk: int | None = None,
                   precision=None) -> Agent:
    if cfg.remat:
        raise ConfigError("learner.remat is not yet ported to "
                          "sharetrade_tpu_torch")
    optimizer = build_optimizer(cfg)
    precision = precision or FP32
    apply_update = make_update_fn(optimizer, precision)
    unroll = steps_per_chunk or cfg.unroll_len
    n_mb = num_minibatches(cfg, num_agents)
    mb_size = num_agents // n_mb
    device = model.device

    init = make_init(model, env, optimizer, precision, num_agents)

    def minibatch_loss(params, traj_mb, carry_mb, adv_mb, ret_mb):
        logits, values, aux = replay_forward(model, params, traj_mb, carry_mb)
        log_probs = torch.log_softmax(logits, dim=-1)
        logp = log_probs.gather(-1, traj_mb.action[..., None])[..., 0]
        weight = traj_mb.active
        denom = torch.clamp(weight.sum(), min=1.0)
        adv = normalize_advantages_masked(adv_mb, weight, denom)
        ratio = torch.exp(logp - traj_mb.logp)
        clipped = torch.clamp(ratio, 1.0 - cfg.clip_eps, 1.0 + cfg.clip_eps)
        policy_loss = -(torch.minimum(ratio * adv, clipped * adv)
                        * weight).sum() / denom
        value_loss = (torch.square(values - ret_mb) * weight).sum() / denom
        entropy = -((torch.exp(log_probs) * log_probs).sum(dim=-1)
                    * weight).sum() / denom
        total = (policy_loss + cfg.value_coef * value_loss
                 - cfg.entropy_coef * entropy + cfg.aux_loss_coef * aux)
        return total, (policy_loss, value_loss, entropy)

    def minibatch_grads(compute, traj_mb, carry_mb, adv_mb, ret_mb,
                        marker=None):
        """Loss terms ``[total, policy, value, entropy]`` and the gradients
        with respect to ``compute``, the compute copy of the masters (the
        masters themselves in fp32), as a leaf list."""
        leaves = [c.detach().requires_grad_() for c in tree_leaves(compute)]
        with torch.enable_grad():
            total, aux = minibatch_loss(unflatten_like(compute, leaves),
                                        traj_mb, carry_mb, adv_mb, ret_mb)
            if marker is not None:
                marker("replay_fwd")
            grads = torch.autograd.grad(total, leaves)
        if marker is not None:
            marker("replay_bwd")
        return torch.stack([total.detach(), *(a.detach() for a in aux)]), \
            list(grads)

    def draw(ts: TrainState) -> Draws:
        gumbel = gumbel_noise((unroll, num_agents, model.num_actions), ts.rng,
                              device)
        return Draws(gumbel, torch.stack([
            torch.randperm(num_agents, generator=ts.rng, device=device)
            for _ in range(cfg.ppo_epochs)]))

    def step(ts: TrainState, draws: Draws | None = None, marker=None):
        if draws is None:
            draws = draw(ts)
        compute = precision.cast_compute(ts.params)
        ts, traj, bootstrap, init_carry = collect_rollout(
            model, env, ts, unroll, num_agents, params=compute,
            gumbel=draws.gumbel, marker=marker)
        with torch.no_grad():
            advantages = gae_advantages(traj.reward, traj.value, traj.active,
                                        bootstrap, cfg.gamma, cfg.gae_lambda)
            returns = advantages + traj.value
        if marker is not None:
            marker("gae")
        params, opt_state = ts.params, ts.opt_state
        losses = []
        for epoch in range(cfg.ppo_epochs):
            perm = draws.perms[epoch].to(device=device, dtype=torch.int64)
            for mb in range(n_mb):
                idx = perm[mb * mb_size:(mb + 1) * mb_size]
                traj_mb = traj.take(idx)
                carry_mb = tree_map(lambda v: v.index_select(0, idx),
                                    init_carry)
                terms, grads = minibatch_grads(
                    compute, traj_mb, carry_mb,
                    advantages.index_select(1, idx),
                    returns.index_select(1, idx), marker)
                with torch.no_grad():
                    params, opt_state, compute = apply_update(
                        grads, opt_state, params)
                if marker is not None:
                    marker("update")
                losses.append(terms)
        total, policy_l, value_l, entropy = torch.stack(losses).mean(dim=0)
        ts = ts.replace(params=params, opt_state=opt_state,
                        updates=ts.updates + cfg.ppo_epochs * n_mb)
        with torch.no_grad():
            metrics = {
                "loss": total, "policy_loss": policy_l,
                "value_loss": value_l, "entropy": entropy,
                "reward_sum": traj.reward.sum(),
                "env_steps": ts.env_steps, "updates": ts.updates,
                **portfolio_metrics(env, ts.env_state),
            }
        return ts, metrics

    return Agent(name="ppo", init=init, step=step, num_agents=num_agents,
                 steps_per_chunk=unroll, model=model,
                 minibatch_grads=minibatch_grads, draw=draw)
