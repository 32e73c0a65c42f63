"""On-policy rollout collection, replay and advantages for PG, A2C and PPO.

Counterpart of the JAX package's ``agents/rollout.py``: the precomputed-
trunk rollout (the whole unroll's banded trunk in one pass for one
representative agent, then a sequential loop of the small per-step head and
env transition), the generic per-step rollout for models without that pair
(the MLPs: one batched forward and one env step per step), the
differentiable replay of the stored trajectory, returns-to-go, GAE and the
masked advantage normalisation.

The sequential loop is a Python loop of small tensor ops over the agent
batch. It never synchronises with the host: no ``.item()``, no Python
branch on a tensor's value, the representative chosen on the device.
Trajectories are written into preallocated ``(T, B, ...)`` tensors. On the
card the whole chunk, this loop included, is captured in one CUDA graph
(``agents/base.py`` ``ChunkProgram``).

:func:`greedy_rollout_precomputed` is the greedy evaluation's replay: one
agent, argmax actions, the whole episode's trunk in one banded pass;
:func:`greedy_rollout` the same for the other models, step by step.

The replay of a stateless model folds the trajectory batch-major into
groups of at most ``_MAX_FOLD_ROWS`` rows, as the JAX package does (the
MoE's top-k routing groups tokens in that order); a model with a carry (the
LSTM) replays step by step from the unroll's initial carry. With
``remat=True`` (``learner.remat``) the replay checkpoints the units the
JAX package does: the whole banded replay, each fold group, or each step.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from sharetrade_tpu_torch.agents.base import (
    TrainState, election_health, quarantine_mask, select_rows)
from sharetrade_tpu_torch.env.core import TradingEnv
from sharetrade_tpu_torch.models.core import (
    Model, checkpointed, tree_leaves, tree_map)


class StepData(NamedTuple):
    """A trajectory, time-major: every field (T, B, ...)."""

    obs: torch.Tensor      # (T, B, obs_dim) float32
    action: torch.Tensor   # (T, B) int64
    logp: torch.Tensor     # (T, B) log-prob of the sampled action
    value: torch.Tensor    # (T, B) critic estimate at obs
    reward: torch.Tensor   # (T, B)
    active: torch.Tensor   # (T, B) float32, 1.0 while the episode runs

    def take(self, idx: torch.Tensor) -> "StepData":
        """The agents ``idx`` (a device index tensor) of every field."""
        return StepData(*(x.index_select(1, idx) for x in self))


def supports_precomputed_trunk(model: Model, env: TradingEnv) -> bool:
    """The precomputed-rollout path needs the model's trunk pair and the
    single-asset layout with a priced step."""
    return (model.apply_rollout_trunk is not None
            and env.num_assets == 1 and env.step_priced is not None)


def gumbel_noise(shape, generator: torch.Generator,
                 device: torch.device) -> torch.Tensor:
    """Standard Gumbel noise, ``-log(-log(U))`` with U uniform in
    [tiny, 1): ``argmax(logits + g)`` is a categorical draw."""
    u = torch.rand(shape, generator=generator, device=device)
    u = torch.clamp(u, min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def collect_rollout(model: Model, env: TradingEnv, ts: TrainState,
                    unroll_len: int, num_agents: int, params=None,
                    gumbel: torch.Tensor | None = None, marker=None):
    """Roll the policy forward ``unroll_len`` steps; returns ``(new_ts,
    traj, bootstrap_value, init_carry)``. ``params`` overrides the weights
    the forwards read (the precision policy's compute copy); ``gumbel`` (T,
    B, A) replaces the sampling noise the rollout would draw from
    ``ts.rng`` (the tests hand in the JAX package's draws). ``marker``,
    when given, is called with ``"trunk"`` and ``"rollout_loop"`` as each
    part is enqueued (``chip_smoke.py`` records a CUDA event there)."""
    if supports_precomputed_trunk(model, env):
        return _collect_rollout_precomputed(model, env, ts, unroll_len,
                                            num_agents, params=params,
                                            gumbel=gumbel, marker=marker)
    return _collect_rollout_generic(model, env, ts, unroll_len, num_agents,
                                    params=params, gumbel=gumbel,
                                    marker=marker)


def _collect_rollout_generic(model: Model, env: TradingEnv, ts: TrainState,
                             unroll_len: int, num_agents: int, params=None,
                             gumbel: torch.Tensor | None = None, marker=None):
    """The per-step rollout: each step observes every agent, runs one
    batched forward (``model.apply_batch``), samples ``argmax(logits + g)``
    (a categorical draw, as ``jax.random.categorical`` makes it) and steps
    the env. A row whose observation or env state is not finite is zeroed
    and masked inactive (``quarantine_mask``), as is a row past the
    horizon."""
    params = ts.params if params is None else params
    horizon = env.num_steps
    init_carry = ts.carry
    device = ts.env_state.t.device
    b = num_agents
    with torch.no_grad():
        if gumbel is None:
            gumbel = gumbel_noise((unroll_len, b, model.num_actions), ts.rng,
                                  device)
        obs = torch.empty((unroll_len, b, model.obs_dim), dtype=torch.float32,
                          device=device)
        action = torch.empty((unroll_len, b), dtype=torch.int64,
                             device=device)
        logp = torch.empty((unroll_len, b), dtype=torch.float32,
                           device=device)
        value = torch.empty_like(logp)
        reward = torch.empty_like(logp)
        active = torch.empty_like(logp)
        zero = torch.zeros((), dtype=torch.float32, device=device)
        env_state, carry = ts.env_state, ts.carry
        for i in range(unroll_len):
            obs_raw = env.observe(env_state)
            healthy = quarantine_mask(obs_raw, env_state)
            mask = (env_state.t < horizon) & healthy
            obs_i = torch.where(healthy[:, None], obs_raw, zero, out=obs[i])
            out, carry = model.apply_batch(params, obs_i, carry)
            a = torch.argmax(out.logits + gumbel[i], dim=-1)
            logp[i] = torch.log_softmax(out.logits, dim=-1).gather(
                -1, a[:, None])[:, 0]
            value[i] = out.value
            stepped, r = env.step(env_state, a)
            env_state = select_rows(mask, stepped, env_state)
            # where(), not *: a quarantined row's reward is NaN.
            reward[i] = torch.where(mask, r, zero)
            action[i] = a
            active[i] = mask.float()
        final_raw = env.observe(env_state)
        final_fine = quarantine_mask(final_raw, env_state)
        final_out, _ = model.apply_batch(
            params, torch.where(final_fine[:, None], final_raw, zero), carry)
        bootstrap = final_out.value * (
            (env_state.t < horizon) & final_fine).float()
        steps_taken = (active > 0).any(dim=1).sum().to(torch.int32)
        if marker is not None:
            marker("rollout_loop")
    traj = StepData(obs=obs, action=action, logp=logp, value=value,
                    reward=reward, active=active)
    new_ts = ts.replace(env_state=env_state, carry=carry,
                        env_steps=ts.env_steps + steps_taken)
    return new_ts, traj, bootstrap, init_carry


def _trunk_precompute(model: Model, env: TradingEnv, params, state1, carry1,
                      t_len: int, horizon: int):
    """Single-representative precompute: the (T+1) price windows of the
    unroll (cursors clamped at the horizon), the trade prices (the newest
    tick of window i+1 for step i — fed to BOTH the trunk and the priced
    step) and the trunk. ``state1``/``carry1`` are batch-of-1. Returns
    ``(windows (T+1, W), trade_prices (T,), hn_base (T+1, d), carry_out)``.
    """
    window = model.obs_dim - 2
    steps = torch.arange(t_len + 1, dtype=torch.int32, device=state1.t.device)
    cursors = torch.clamp(state1.t + steps, max=horizon)          # (T+1,)
    shifted = state1.map(lambda x: x.expand(t_len + 1)).replace(t=cursors)
    windows = env.observe(shifted)[:, :window]                    # (T+1, W)
    obs1_raw = env.observe(state1)
    # Sanitise only the wallet: the price window comes from the series and
    # is all the trunk reads.
    wallet = obs1_raw[:, window:]
    obs1 = torch.cat([obs1_raw[:, :window],
                      torch.where(torch.isfinite(wallet), wallet,
                                  torch.zeros_like(wallet))], dim=-1)
    hn1, carry_out = model.apply_rollout_trunk(
        params, obs1, windows[None, 1:, -1], carry1)
    return windows, windows[1:, -1], hn1[0], carry_out


def _collect_rollout_precomputed(model: Model, env: TradingEnv,
                                 ts: TrainState, unroll_len: int,
                                 num_agents: int, params=None,
                                 gumbel: torch.Tensor | None = None,
                                 marker=None):
    """Rollout with the trunk hoisted out of the sequential loop; see the
    JAX package's ``_collect_rollout_precomputed`` for the agent-invariance
    argument (every healthy agent replays the same series in lockstep, so
    one representative's trunk serves all). Agents frozen mid-unroll read
    trunk rows computed for cursors they never reached; their outputs are
    masked inactive."""
    params = ts.params if params is None else params
    horizon = env.num_steps
    init_carry = ts.carry
    window = model.obs_dim - 2
    device = ts.env_state.t.device
    b = num_agents

    with torch.no_grad():
        # The representative: the first row healthy by the heal's predicate.
        rep = torch.argmax(
            election_health(ts.env_state, ts.carry).to(torch.int32)).reshape(1)
        state1 = ts.env_state.map(lambda x: x.index_select(0, rep))
        carry1 = {k: v.index_select(0, rep) for k, v in ts.carry.items()}
        windows, trade_prices, hn_base, carry1_out = _trunk_precompute(
            model, env, params, state1, carry1, unroll_len, horizon)
        new_carry = {k: v.expand((b,) + v.shape[1:])
                     for k, v in carry1_out.items()}
        if marker is not None:
            marker("trunk")

        if gumbel is None:
            gumbel = gumbel_noise((unroll_len, b, model.num_actions), ts.rng,
                                  device)
        base_l, base_v, pf_fn = model.rollout_head_factored(params, hn_base)
        windows_ok = torch.isfinite(windows).all(dim=-1)            # (T+1,)

        obs = torch.empty((unroll_len, b, window + 2), dtype=torch.float32,
                          device=device)
        action = torch.empty((unroll_len, b), dtype=torch.int64,
                             device=device)
        logp = torch.empty((unroll_len, b), dtype=torch.float32,
                           device=device)
        value = torch.empty_like(logp)
        reward = torch.empty_like(logp)
        active = torch.empty_like(logp)
        zero = torch.zeros((), dtype=torch.float32, device=device)

        def healthy_rows(env_state, window_ok):
            # quarantine_mask(obs_raw, env_state) without building obs_raw:
            # every row's window is the shared one, and the int cursor is
            # always finite, so what remains is the float fields.
            fields = torch.stack([env_state.budget, env_state.shares,
                                  env_state.share_value])
            return window_ok & torch.isfinite(fields).all(dim=0)

        env_state = ts.env_state
        for i in range(unroll_len):
            obs_raw = torch.cat([windows[i].expand(b, window),
                                 env_state.budget[:, None],
                                 env_state.shares[:, None]], dim=-1)
            healthy = healthy_rows(env_state, windows_ok[i])
            act = ((env_state.t < horizon) & healthy).float()
            obs_i = torch.where(healthy[:, None], obs_raw, zero, out=obs[i])
            d_l, d_v = pf_fn(obs_i)
            logits = base_l[i][None] + d_l
            value[i] = base_v[i] + d_v
            a = torch.argmax(logits + gumbel[i], dim=-1)
            log_probs = torch.log_softmax(logits, dim=-1)
            logp[i] = (log_probs * torch.nn.functional.one_hot(
                a, log_probs.shape[-1])).sum(dim=-1)
            stepped, r = env.step_priced(env_state, a, trade_prices[i])
            mask = act.bool()
            env_state = select_rows(mask, stepped, env_state)
            reward[i] = torch.where(mask, r, zero)
            action[i] = a
            active[i] = act

        final_raw = env.observe(env_state)
        final_fine = healthy_rows(env_state, windows_ok[unroll_len])
        final_obs = torch.where(final_fine[:, None], final_raw, zero)
        _, d_v = pf_fn(final_obs)
        bootstrap = (base_v[unroll_len] + d_v) * (
            (env_state.t < horizon) & final_fine).float()

        steps_taken = (active > 0).any(dim=1).sum().to(torch.int32)
        if marker is not None:
            marker("rollout_loop")
    traj = StepData(obs=obs, action=action, logp=logp, value=value,
                    reward=reward, active=active)
    new_ts = ts.replace(env_state=env_state, carry=new_carry,
                        env_steps=ts.env_steps + steps_taken)
    return new_ts, traj, bootstrap, init_carry


def greedy_rollout_precomputed(model: Model, env: TradingEnv, params,
                               *, horizon: int | None = None):
    """Greedy (argmax) single-agent episode replay through the precomputed
    trunk, the ``evaluate()`` path for trunk models: prices do not depend
    on actions, so the whole episode's trunk is one banded pass (one
    ``flash_fwd`` launch per layer over the history, the window and the
    horizon), then a loop of the factored head and the env step. Returns
    ``(final_env_state, rewards (T,))``; the state is batch-of-1."""
    horizon = env.num_steps if horizon is None else horizon
    with torch.no_grad():
        state = env.reset().map(lambda x: x[None])
        carry1 = {k: v[None] for k, v in model.init_carry().items()}
        windows, trade_prices, hn_base, _ = _trunk_precompute(
            model, env, params, state, carry1, horizon, horizon)
        base_l, _, pf_fn = model.rollout_head_factored(params, hn_base)
        rewards = torch.empty((horizon,), dtype=torch.float32,
                              device=windows.device)
        for i in range(horizon):
            obs = torch.cat([windows[i][None], state.budget[:, None],
                             state.shares[:, None]], dim=-1)
            logits = base_l[i][None] + pf_fn(obs)[0]
            action = torch.argmax(logits, dim=-1)
            state, reward = env.step_priced(state, action, trade_prices[i])
            rewards[i] = reward[0]
    return state, rewards


def greedy_rollout(model: Model, env: TradingEnv, params, carry0,
                   *, horizon: int | None = None):
    """Greedy (argmax) single-agent episode replay, one batched forward of
    one row and one env step per step: the ``evaluate()`` path for models
    without the precomputed trunk (the JAX orchestrator's ``greedy_scan``).
    ``carry0`` is one session's initial carry in the compute dtype. Returns
    ``(final_env_state, rewards (T,))``; the state is batch-of-1."""
    horizon = env.num_steps if horizon is None else horizon
    with torch.no_grad():
        state = env.reset().map(lambda x: x[None])
        carry = tree_map(lambda v: v[None], carry0)
        rewards = torch.empty((horizon,), dtype=torch.float32,
                              device=state.t.device)
        for i in range(horizon):
            out, carry = model.apply_batch(params, env.observe(state), carry)
            state, reward = env.step(state, torch.argmax(out.logits, dim=-1))
            rewards[i] = reward[0]
    return state, rewards


#: Most observation rows per folded forward call of a stateless replay
#: (the JAX package's cap; with MoE top-k it also fixes the routing groups).
_MAX_FOLD_ROWS = 2048


def _mean_aux(out, device) -> torch.Tensor:
    """``out.aux`` as a float32 scalar on ``device``. A model's constant
    0.0 is filled on the device: a host tensor copied up would refuse a
    CUDA graph's capture."""
    if isinstance(out.aux, torch.Tensor):
        return out.aux.float().mean()
    return torch.full((), float(out.aux), dtype=torch.float32, device=device)


def replay_forward(model: Model, params: Any, traj: StepData, init_carry,
                   *, remat: bool = False):
    """Recompute ``(logits (T, B, A), values (T, B), aux)`` along a stored
    trajectory under ``params`` — the differentiable forward of the loss;
    ``aux`` is the mean of the model's ``ModelOut.aux`` over the replay
    (the MoE balance term; 0 for dense models). In order of preference:

    - the shared-trunk replay, or the per-agent banded replay, when the
      model has one (the episode transformer);
    - a stateless model (empty carry): the (T, B) trajectory folded
      batch-major, (T, B) -> (B, T) before the merge, in groups of ``fold``
      steps, ``fold`` the largest divisor of T with ``fold x B`` at most
      ``_MAX_FOLD_ROWS`` (one group at the configs here); aux the mean
      over the groups. The row order and the group boundaries are the JAX
      package's: the MoE's top-k routing drops picks by them;
    - a model with a carry: ``model.apply_batch`` step by step from
      ``init_carry`` (the JAX package's scan), aux the mean over steps.

    ``remat`` checkpoints (``models.core.checkpointed``) the whole banded
    replay, each fold group, or each step, as the JAX package's
    ``jax.checkpoint`` does: the backward recomputes that unit's
    activations from its inputs instead of keeping them."""
    if model.apply_unroll_shared is not None:
        return checkpointed(model.apply_unroll_shared, remat)(
            params, traj.obs, init_carry)
    if model.apply_unroll is not None:
        return checkpointed(model.apply_unroll, remat)(
            params, traj.obs, init_carry)
    t, b = traj.obs.shape[:2]
    device = traj.obs.device
    logits, values, aux = [], [], []
    if not tree_leaves(init_carry):
        fold = max(f for f in range(1, t + 1)
                   if t % f == 0 and (f * b <= _MAX_FOLD_ROWS or f == 1))

        def group(params, obs_g):
            # (fold, B, D) -> (B, fold, D) -> (B * fold, D): batch-major.
            out, _ = model.apply_batch(
                params, obs_g.transpose(0, 1).reshape(b * fold, -1),
                init_carry)
            return (out.logits.reshape(b, fold, -1).transpose(0, 1),
                    out.value.reshape(b, fold).transpose(0, 1),
                    _mean_aux(out, device))

        group = checkpointed(group, remat)
        for g in range(t // fold):
            lg, vg, ag = group(params, traj.obs[g * fold:(g + 1) * fold])
            logits.append(lg)
            values.append(vg)
            aux.append(ag)
        return torch.cat(logits), torch.cat(values), torch.stack(aux).mean()

    def one_step(params, obs_t, carry):
        out, carry = model.apply_batch(params, obs_t, carry)
        return out.logits, out.value, _mean_aux(out, device), carry

    one_step = checkpointed(one_step, remat)
    carry = init_carry
    for i in range(t):
        lg, vg, ag, carry = one_step(params, traj.obs[i], carry)
        logits.append(lg)
        values.append(vg)
        aux.append(ag)
    return torch.stack(logits), torch.stack(values), torch.stack(aux).mean()


def discounted_returns(rewards: torch.Tensor, active: torch.Tensor,
                       bootstrap: torch.Tensor, gamma: float) -> torch.Tensor:
    """Returns-to-go ``R_t = r_t + gamma R_{t+1} live_t`` over (T, B),
    seeded with the bootstrap value, as a reverse loop over time."""
    returns = torch.empty_like(rewards)
    r_next = bootstrap
    for t in range(rewards.shape[0] - 1, -1, -1):
        r_next = torch.add(rewards[t], gamma * r_next * active[t],
                           out=returns[t])
    return returns


def normalize_advantages_masked(adv: torch.Tensor, weight: torch.Tensor,
                                denom: torch.Tensor) -> torch.Tensor:
    """Zero-mean unit-variance advantages over the ACTIVE steps, re-masked;
    ``weight`` is the binary active mask, ``denom`` its clamped sum."""
    mean = (adv * weight).sum() / denom
    var = (torch.square(adv - mean) * weight).sum() / denom
    return (adv - mean) * torch.rsqrt(var + 1e-8) * weight


def gae_advantages(rewards, values, active, bootstrap, gamma: float,
                   lam: float) -> torch.Tensor:
    """Generalized Advantage Estimation over (T, B) tensors, gated on the
    NEXT step's liveness (the final slice's successor is ``bootstrap``,
    already zero when the episode ended, so its liveness is 1)."""
    next_values = torch.cat([values[1:], bootstrap[None]], dim=0)
    next_active = torch.cat([active[1:], torch.ones_like(bootstrap)[None]],
                            dim=0)
    delta = rewards + gamma * next_values * next_active - values
    coef = gamma * lam * next_active
    adv = torch.empty_like(delta)
    adv_next = torch.zeros_like(bootstrap)
    for t in range(delta.shape[0] - 1, -1, -1):
        adv_next = torch.addcmul(delta[t], adv_next, coef[t], out=adv[t])
    return adv
