"""DQN with a replay buffer on the device, uniform or prioritized.

Counterpart of the JAX package's ``agents/dqn.py``. The replay is a set of
fixed-size circular tensors (its write position and size are device
scalars), so pushing, sampling and the TD update never wait for the host.
A target network, synced every ``target_update_every`` updates, gives the
bootstrap. ``learner.replay_priority="per"`` adds the sum-tree sampler
(``ops/sum_tree.py``): new transitions enter at the running max priority,
the sample is stratified with importance-sampling weights in the loss, and
the sampled transitions' TD errors are written back as their priorities.

Per env step, as the JAX step: epsilon-greedy actions from the online
network, the env transition, the push of the active agents' transitions,
one minibatch sample, the TD loss against the target network, and the
update, gated on the device until the replay holds a minibatch
(``fused_update``'s ``gate``). The target sync is a device-side select.

Random draws (``Draws``): the epsilon-greedy gates and random actions as in
``agents/qlearn.py``, and per step either the uniform sample's indices or
the PER strata's uniforms. From ``ts.rng`` for the whole chunk up front
(the agent's ``draw``; the uniform indices as ``floor(u * size)``), or
handed in (the tests
recreate the JAX step's draws, indices included).

``collect_transitions`` (``learner.journal_replay``) makes each chunk also
return its transitions under ``metrics["transitions"]``: the step's
``obs``, ``action``, ``reward``, ``next_obs`` and ``valid`` (the active
mask), written into (T, B, ...) tensors allocated once per chunk, which the
orchestrator journals (``data/transitions.py``) and warm-starts the replay
from (``fill_replay_from_arrays``; ``fill_replay_from_events`` for legacy
JSON ``transitions`` events).
"""

from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Any, NamedTuple

import torch

from sharetrade_tpu_torch.agents.base import (
    Agent, TrainState, build_optimizer, epsilon_greedy, exploit_probability,
    make_init, make_update_fn, per_beta, portfolio_metrics, quarantine_mask,
    select_rows)
from sharetrade_tpu_torch.agents.qlearn import q_values
from sharetrade_tpu_torch.config import ConfigError, LearnerConfig
from sharetrade_tpu_torch.env.core import TradingEnv
from sharetrade_tpu_torch.models.core import (
    Model, tree_leaves, tree_map, unflatten_like)
from sharetrade_tpu_torch.ops import sum_tree
from sharetrade_tpu_torch.precision import FP32


@dataclass
class ReplayBuffer:
    obs: torch.Tensor       # (cap, obs_dim) float32
    action: torch.Tensor    # (cap,) int32
    reward: torch.Tensor    # (cap,) float32
    next_obs: torch.Tensor  # (cap, obs_dim) float32
    pos: torch.Tensor       # int32 next write index
    size: torch.Tensor      # int32 valid entries

    @classmethod
    def create(cls, capacity: int, obs_dim: int, device=None
               ) -> "ReplayBuffer":
        def zeros(*shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=device)

        return cls(obs=zeros(capacity, obs_dim),
                   action=zeros(capacity, dtype=torch.int32),
                   reward=zeros(capacity), next_obs=zeros(capacity, obs_dim),
                   pos=zeros(dtype=torch.int32), size=zeros(dtype=torch.int32))

    def push(self, obs, action, reward, next_obs, valid) -> "ReplayBuffer":
        """Insert a batch of B transitions, wrapping; see
        :meth:`push_with_plan`."""
        return self.push_with_plan(obs, action, reward, next_obs, valid)[0]

    def push_with_plan(self, obs, action, reward, next_obs, valid):
        """Write the ``valid`` rows at ``pos, pos+1, ...`` (compacted to the
        front, in order); the others rewrite slot ``pos - 1`` with its own
        contents (a no-op). In place. Returns ``(buffer, slot_idx,
        write_mask)`` so the PER sum-tree can mirror exactly the slots
        written."""
        batch = obs.shape[0]
        capacity = self.obs.shape[0]
        order = torch.argsort((~valid).to(torch.uint8), stable=True)
        n_valid = valid.sum().to(torch.int32)
        rows = torch.arange(batch, dtype=torch.int32, device=obs.device)
        idx = (self.pos + rows) % capacity
        write = rows < n_valid
        safe_idx = torch.where(write, idx, (self.pos - 1) % capacity).long()
        for buf, new in ((self.obs, obs), (self.action, action),
                         (self.reward, reward), (self.next_obs, next_obs)):
            new = new.index_select(0, order).to(buf.dtype)
            keep = write.reshape((-1,) + (1,) * (new.ndim - 1))
            buf.index_copy_(0, safe_idx,
                            torch.where(keep, new, buf.index_select(0,
                                                                    safe_idx)))
        self.pos = (self.pos + n_valid) % capacity
        self.size = torch.clamp(self.size + n_valid, max=capacity)
        return self, safe_idx, write

    def sample(self, u: torch.Tensor):
        """A uniform minibatch of the valid slots from the uniforms ``u``
        in [0, 1): slot ``floor(u * size)`` (the JAX buffer draws
        ``randint(key, (batch,), 0, size)``; the device-side size is never
        read back)."""
        high = torch.clamp(self.size, min=1)
        return self.take(torch.minimum((u * high).long(), high - 1))

    def take(self, idx: torch.Tensor):
        """``(obs, action, reward, next_obs)`` at the slots ``idx``."""
        return (self.obs.index_select(0, idx),
                self.action.index_select(0, idx).long(),
                self.reward.index_select(0, idx),
                self.next_obs.index_select(0, idx))


@dataclass
class PerState:
    """The PER sum-tree (leaf i: replay slot i's priority, already raised to
    ``per_alpha``) and the running max priority new transitions enter at."""

    tree: sum_tree.SumTree
    max_priority: torch.Tensor   # float32 scalar


@dataclass
class DQNExtras:
    """DQN's own state in ``TrainState.extras``; ``per`` is None under
    uniform replay."""

    target_params: Any
    replay: ReplayBuffer
    per: PerState | None = None


def extras_tree(extras: DQNExtras) -> dict:
    """The extras as a nested dict of tensors (checkpoints, ``convert``):
    ``target_params``, ``replay.{obs, action, reward, next_obs, pos,
    size}`` and, under PER, ``per.tree`` (the levels, leaves first) and
    ``per.max_priority``."""
    tree = {"target_params": extras.target_params,
            "replay": {f.name: getattr(extras.replay, f.name)
                       for f in fields(ReplayBuffer)}}
    if extras.per is not None:
        tree["per"] = {"tree": list(extras.per.tree.levels),
                       "max_priority": extras.per.max_priority}
    return tree


def extras_from_tree(tree: dict) -> DQNExtras:
    """Inverse of :func:`extras_tree`."""
    per = tree.get("per")
    return DQNExtras(
        target_params=tree["target_params"],
        replay=ReplayBuffer(**tree["replay"]),
        per=None if per is None else PerState(
            tree=sum_tree.SumTree(levels=list(per["tree"])),
            max_priority=per["max_priority"]))


class Draws(NamedTuple):
    """Pre-drawn randomness for one DQN chunk."""

    gate: torch.Tensor            # (T, B) float32 uniforms
    random_action: torch.Tensor   # (T, B) int64
    sample: torch.Tensor          # (T, batch) float32 uniforms (PER: the
    #                               strata's), or the uniform sampler's
    #                               integer slot indices themselves


def make_dqn_agent(model: Model, env: TradingEnv, cfg: LearnerConfig, *,
                   num_agents: int = 10, steps_per_chunk: int = 200,
                   collect_transitions: bool = False,
                   precision=None) -> Agent:
    if cfg.replay_priority not in ("uniform", "per"):
        raise ConfigError(
            f"unknown learner.replay_priority {cfg.replay_priority!r} "
            "(expected 'uniform' or 'per')")
    if cfg.replay_capacity <= num_agents:
        raise ConfigError(
            f"learner.replay_capacity ({cfg.replay_capacity}) must exceed "
            f"the agent batch ({num_agents}): a push spanning the whole "
            "circular buffer has implementation-defined slot winners")
    use_per = cfg.replay_priority == "per"
    optimizer = build_optimizer(cfg)
    precision = precision or FP32
    apply_update = make_update_fn(optimizer, precision)
    horizon = env.num_steps
    device = model.device
    batch = cfg.replay_batch

    def new_extras(params) -> DQNExtras:
        return DQNExtras(
            target_params=tree_map(torch.clone, params),
            replay=ReplayBuffer.create(cfg.replay_capacity, model.obs_dim,
                                       device),
            per=PerState(
                tree=sum_tree.create(cfg.replay_capacity, device),
                max_priority=torch.ones((), dtype=torch.float32,
                                        device=device))
            if use_per else None)

    init = make_init(model, env, optimizer, precision, num_agents, new_extras)

    def td_gradients(compute, target_c, b_obs, b_act, b_rew, b_next,
                     weights=None):
        """One copy of the TD math for both samplers: the loss, the TD
        errors and the gradients with respect to ``compute``."""
        leaves = [p.detach().requires_grad_() for p in tree_leaves(compute)]
        with torch.no_grad():
            q_next = q_values(model, target_c, b_next)
        with torch.enable_grad():
            q_s = q_values(model, unflatten_like(compute, leaves), b_obs)
            target = b_rew + cfg.gamma * q_next.max(dim=-1).values
            predicted = q_s.gather(-1, b_act[:, None])[:, 0]
            td_err = predicted - target
            sq = torch.square(td_err)
            loss = (sq if weights is None else weights * sq).mean()
            grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), td_err.detach(), list(grads)

    def draw(ts: TrainState) -> Draws:
        return Draws(
            torch.rand((steps_per_chunk, num_agents), generator=ts.rng,
                       device=device),
            torch.randint(0, model.num_actions, (steps_per_chunk, num_agents),
                          generator=ts.rng, device=device),
            torch.rand((steps_per_chunk, batch), generator=ts.rng,
                       device=device))

    def step(ts: TrainState, draws: Draws | None = None):
        if draws is None:
            draws = draw(ts)
        params, opt_state = ts.params, ts.opt_state
        env_state, env_steps, updates = ts.env_state, ts.env_steps, ts.updates
        extras = ts.extras
        replay, per = extras.replay, extras.per
        target_leaves = tree_leaves(extras.target_params)
        compute = precision.cast_compute(params)
        target_c = precision.cast_compute(extras.target_params)
        losses = torch.empty((steps_per_chunk,), dtype=torch.float32,
                             device=device)
        rewards_sum = torch.zeros((), dtype=torch.float32, device=device)
        zero = torch.zeros((), dtype=torch.float32, device=device)
        taken: list[tuple] = []       # per step (obs, action, reward, next, valid)
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
                replay, push_idx, push_write = replay.push_with_plan(
                    obs, actions, rewards, next_obs, active)
                if collect_transitions:
                    taken.append((obs, actions, rewards, next_obs, active))
                weights = None
                if use_per:
                    sum_tree.set_priorities(
                        per.tree, push_idx,
                        per.max_priority.expand(push_idx.shape), push_write)
                    sample_idx, probs = sum_tree.sample_stratified(
                        per.tree, draws.sample[i])
                    weights = sum_tree.is_weights(
                        probs, replay.size, per_beta(env_steps, cfg))
                    minibatch = replay.take(sample_idx)
                elif draws.sample.is_floating_point():
                    minibatch = replay.sample(draws.sample[i])
                else:
                    minibatch = replay.take(draws.sample[i].to(torch.int64))
                ready = replay.size >= batch
            loss, td_err, grads = td_gradients(compute, target_c, *minibatch,
                                               weights)
            with torch.no_grad():
                params, opt_state, compute = apply_update(
                    grads, opt_state, params, gate=ready)
                updates = updates + ready.to(torch.int32)
                # Hard target sync every target_update_every updates.
                sync = ready & (updates % cfg.target_update_every == 0)
                for t, p in zip(target_leaves, tree_leaves(params)):
                    t.copy_(torch.where(sync, p, t))
                if precision.mixed:
                    target_c = precision.cast_compute(extras.target_params)
                if use_per:
                    new_p = (td_err.abs() + cfg.per_eps) ** cfg.per_alpha
                    sum_tree.set_priorities(per.tree, sample_idx, new_p,
                                            mask=ready.expand(
                                                sample_idx.shape))
                    per.max_priority = torch.where(
                        ready, torch.maximum(per.max_priority, new_p.max()),
                        per.max_priority)
                env_steps = env_steps + active.any().to(torch.int32)
                losses[i] = torch.where(ready, loss, zero)
                rewards_sum += rewards.sum()
        extras = DQNExtras(target_params=extras.target_params, replay=replay,
                           per=per)
        ts = ts.replace(params=params, opt_state=opt_state,
                        env_state=env_state, env_steps=env_steps,
                        updates=updates, extras=extras)
        with torch.no_grad():
            metrics = {
                "loss": losses.mean(), "reward_sum": rewards_sum,
                "replay_size": replay.size,
                "exploit_prob": exploit_probability(env_steps, cfg),
                "env_steps": env_steps, "updates": updates,
                **portfolio_metrics(env, env_state),
            }
            if use_per:
                metrics["per_max_priority"] = per.max_priority
                metrics["per_beta"] = per_beta(env_steps, cfg)
            if collect_transitions:
                metrics["transitions"] = stack_transitions(taken)
        return ts, metrics

    return Agent(name="dqn", init=init, step=step, num_agents=num_agents,
                 steps_per_chunk=steps_per_chunk, model=model, draw=draw)


#: The fields of a chunk's transitions, in the journal's order, and ``valid``.
TRANSITION_FIELDS = ("obs", "action", "reward", "next_obs", "valid")


def stack_transitions(taken: list[tuple]) -> dict[str, torch.Tensor]:
    """Per-step ``(obs, action, reward, next_obs, valid)`` tensors written
    into (T, B, ...) tensors, one stack per field (five kernels a chunk,
    not five a step)."""
    out = {}
    for name, steps in zip(TRANSITION_FIELDS, zip(*taken)):
        buf = torch.empty((len(steps),) + steps[0].shape,
                          dtype=steps[0].dtype, device=steps[0].device)
        out[name] = torch.stack(steps, out=buf)
    return out


def reseed_per_priorities(extras: DQNExtras, *,
                          priority: float | None = None) -> DQNExtras:
    """Rebuild the PER sum-tree after an out-of-band fill of the replay:
    the first ``replay.size`` slots enter at the running max priority (or
    ``priority``), every other slot is massless. Uniform extras pass
    through."""
    if extras.per is None:
        return extras
    per = extras.per
    n_leaves = per.tree.num_leaves
    p = (per.max_priority if priority is None
         else torch.tensor(priority, dtype=torch.float32,
                           device=per.max_priority.device))
    slots = torch.arange(n_leaves, device=per.max_priority.device)
    leaves = torch.where(slots < extras.replay.size, p,
                         torch.zeros((), device=p.device))
    return DQNExtras(target_params=extras.target_params,
                     replay=extras.replay,
                     per=PerState(tree=sum_tree.from_leaves(leaves),
                                  max_priority=per.max_priority))


def fill_replay_from_journal(replay: ReplayBuffer, journal) -> ReplayBuffer:
    """Push the legacy JSON ``transitions`` events of ``journal`` (its
    tail that fits the buffer) into ``replay``; packed binary records are
    read by ``data/transitions.read_tail_transitions`` instead."""
    return fill_replay_from_events(
        replay, [e for e in journal.replay() if e.get("type") == "transitions"])


def fill_replay_from_events(replay: ReplayBuffer,
                            events: list[dict]) -> ReplayBuffer:
    """Push JSON ``transitions`` events (oldest first) into ``replay``:
    only the newest events that cover the capacity, each in
    capacity-sized slices, so "newest wins" holds deterministically."""
    capacity = replay.obs.shape[0]
    kept, rows = [], 0
    for event in reversed(events):
        kept.append(event)
        rows += len(event["action"])
        if rows >= capacity:
            break
    for event in reversed(kept):
        replay = fill_replay_from_arrays(replay, event["obs"], event["action"],
                                         event["reward"], event["next_obs"])
    return replay


def fill_replay_from_arrays(replay: ReplayBuffer, obs, action, reward,
                            next_obs) -> ReplayBuffer:
    """Push transition arrays (oldest first) into the buffer in
    capacity-sized slices, so "newest wins" holds deterministically."""
    capacity = replay.obs.shape[0]
    device = replay.obs.device

    def tensor(x, dtype):
        return torch.as_tensor(x, dtype=dtype).to(device)

    obs, next_obs = tensor(obs, torch.float32), tensor(next_obs, torch.float32)
    action, reward = tensor(action, torch.int32), tensor(reward, torch.float32)
    for lo in range(0, obs.shape[0], capacity):
        sl = slice(lo, lo + capacity)
        valid = torch.ones((obs[sl].shape[0],), dtype=torch.bool,
                           device=device)
        replay = replay.push(obs[sl], action[sl], reward[sl], next_obs[sl],
                             valid)
    return replay
