"""Online Q-learning: the reference system's algorithm.

Counterpart of the JAX package's ``agents/qlearn.py``. One step does, for
the whole agent batch, what one fold step and four ``Session.run`` calls do
in the reference: epsilon-greedy selection (QDecisionPolicyActor.scala:
58-62), the env transition, the TD(0) target (:66-73) and the AdaGrad
update. ``learner.update_taken_action`` picks the updated coordinate: the
taken action (textbook, the default) or the next state's argmax (the
reference's bug, for parity).

Per step: the selection forward reads the compute copy of the masters; one
stacked forward of Q(s) and Q(s') (``2B`` rows) is differentiated; the loss
is the squared TD error of the active agents, averaged over them. Agents
past the horizon are frozen and a non-finite row is quarantined (zeroed,
masked out of the loss). When no agent is active the update is gated off on
the device (``fused_update``'s ``gate``): params, optimizer state (adam's
count too) and counters stay, as the JAX step's ``where(any_active, ...)``
keeps them. Nothing in the step waits for the host; the orchestrator reads
the chunk's metrics once.

Random draws: per step and agent a uniform gate and a random action
(``Draws``), drawn for the whole chunk from ``ts.rng`` up front (the
agent's ``draw``), or handed in (the tests recreate the JAX step's own
draws; the chunk program hands in the draws it copied into its graph's
buffers).

``step(ts, marker=f)`` calls ``f(name)`` as each part of every step has
been enqueued: ``act_env`` (the selection forward, the epsilon-greedy
choice and the env step), ``forward`` (the stacked TD forward), ``backward``
and ``update`` (the fused update and the counters), so a caller can place
CUDA events there (``chip_smoke.py``'s breakdown); no marker, no cost.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from sharetrade_tpu_torch.agents.base import (
    Agent, TrainState, build_optimizer, epsilon_greedy, exploit_probability,
    make_init, make_update_fn, portfolio_metrics, quarantine_mask,
    select_rows)
from sharetrade_tpu_torch.config import LearnerConfig
from sharetrade_tpu_torch.env.core import TradingEnv
from sharetrade_tpu_torch.models.core import Model, tree_leaves, unflatten_like
from sharetrade_tpu_torch.precision import FP32


class Draws(NamedTuple):
    """Pre-drawn randomness for one chunk of epsilon-greedy steps."""

    gate: torch.Tensor            # (T, B) float32 uniforms in [0, 1)
    random_action: torch.Tensor   # (T, B) int64 in [0, num_actions)


def chunk_draws(rng: torch.Generator, steps: int, num_agents: int,
                num_actions: int, device) -> Draws:
    return Draws(
        torch.rand((steps, num_agents), generator=rng, device=device),
        torch.randint(0, num_actions, (steps, num_agents), generator=rng,
                      device=device))


def q_values(model: Model, params, obs: torch.Tensor) -> torch.Tensor:
    """(N, obs_dim) -> (N, A) Q-values of a stateless Q-head."""
    return model.apply_batch(params, obs, {})[0].logits


def td_gradients(model: Model, compute, obs, next_obs, actions, rewards,
                 active, cfg: LearnerConfig, marker=None):
    """The TD(0) loss of one step and its gradients with respect to
    ``compute``: one stacked forward of Q(s) and Q(s'), the target
    ``r + gamma max Q(s')`` held constant."""
    b = obs.shape[0]
    leaves = [p.detach().requires_grad_() for p in tree_leaves(compute)]
    with torch.enable_grad():
        q_both = q_values(model, unflatten_like(compute, leaves),
                          torch.cat([obs, next_obs], dim=0))
        q_s, q_next = q_both[:b], q_both[b:].detach()
        target = rewards + cfg.gamma * q_next.max(dim=-1).values
        idx = (actions if cfg.update_taken_action
               else torch.argmax(q_next, dim=-1))
        predicted = q_s.gather(-1, idx[:, None])[:, 0]
        per_agent = torch.square(predicted - target) * active
        loss = per_agent.sum() / torch.clamp(active.sum(), min=1.0)
        if marker is not None:
            marker("forward")
        grads = torch.autograd.grad(loss, leaves)
    if marker is not None:
        marker("backward")
    return loss.detach(), list(grads)


def make_qlearn_agent(model: Model, env: TradingEnv, cfg: LearnerConfig, *,
                      num_agents: int = 10, steps_per_chunk: int = 200,
                      precision=None) -> Agent:
    optimizer = build_optimizer(cfg)
    precision = precision or FP32
    apply_update = make_update_fn(optimizer, precision)
    horizon = env.num_steps
    device = model.device
    init = make_init(model, env, optimizer, precision, num_agents)

    def draw(ts: TrainState) -> Draws:
        return chunk_draws(ts.rng, steps_per_chunk, num_agents,
                           model.num_actions, device)

    def step(ts: TrainState, draws: Draws | None = None, marker=None):
        if draws is None:
            draws = draw(ts)
        params, opt_state = ts.params, ts.opt_state
        env_state, env_steps, updates = ts.env_state, ts.env_steps, ts.updates
        compute = precision.cast_compute(params)
        losses = torch.empty((steps_per_chunk,), dtype=torch.float32,
                             device=device)
        rewards_sum = torch.zeros((), dtype=torch.float32, device=device)
        zero = torch.zeros((), dtype=torch.float32, device=device)
        for i in range(steps_per_chunk):
            with torch.no_grad():
                obs_raw = env.observe(env_state)
                healthy = quarantine_mask(obs_raw, env_state)
                active = (env_state.t < horizon) & healthy
                obs = torch.where(healthy[:, None], obs_raw, zero)
                actions = epsilon_greedy(
                    q_values(model, compute, obs), draws.gate[i],
                    draws.random_action[i].to(torch.int64), env_steps, cfg)
                stepped, rewards = env.step(env_state, actions)
                env_state = select_rows(active, stepped, env_state)
                rewards = torch.where(active, rewards, zero)
                next_obs = torch.where(healthy[:, None],
                                       env.observe(env_state), zero)
            if marker is not None:
                marker("act_env")
            losses[i], grads = td_gradients(
                model, compute, obs, next_obs, actions, rewards,
                active.float(), cfg, marker)
            with torch.no_grad():
                any_active = active.any()
                params, opt_state, compute = apply_update(
                    grads, opt_state, params, gate=any_active)
                env_steps = env_steps + any_active.to(torch.int32)
                updates = updates + any_active.to(torch.int32)
                rewards_sum += rewards.sum()
            if marker is not None:
                marker("update")
        ts = ts.replace(params=params, opt_state=opt_state,
                        env_state=env_state, env_steps=env_steps,
                        updates=updates)
        with torch.no_grad():
            metrics = {
                "loss": losses.mean(), "reward_sum": rewards_sum,
                "exploit_prob": exploit_probability(env_steps, cfg),
                "env_steps": env_steps, "updates": updates,
                **portfolio_metrics(env, env_state),
            }
        return ts, metrics

    return Agent(name="qlearn", init=init, step=step, num_agents=num_agents,
                 steps_per_chunk=steps_per_chunk, model=model, draw=draw)
