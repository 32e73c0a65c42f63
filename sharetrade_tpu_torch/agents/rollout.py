"""On-policy rollout collection, replay and advantages for PPO.

Counterpart of the JAX package's ``agents/rollout.py``: the precomputed-
trunk rollout (the whole unroll's banded trunk in one pass for one
representative agent, then a sequential loop of the small per-step head and
env transition), the differentiable replay of the stored trajectory, GAE and
the masked advantage normalisation.

The sequential loop is a Python loop of small tensor ops over the agent
batch. It never synchronises with the host: no ``.item()``, no Python
branch on a tensor's value, the representative chosen on the device.
Trajectories are written into preallocated ``(T, B, ...)`` tensors. Making
the loop one CUDA graph or one kernel is later work.

Not yet ported: the generic per-step rollout (``collect_rollout`` raises
for models without the precomputed-trunk pair), the folded stateless
replay and the scanned recurrent replay.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from sharetrade_tpu_torch.agents.base import TrainState, election_health
from sharetrade_tpu_torch.config import ConfigError
from sharetrade_tpu_torch.env.core import TradingEnv
from sharetrade_tpu_torch.models.core import Model


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
    if not supports_precomputed_trunk(model, env):
        raise ConfigError(
            f"the generic per-step rollout ({model.name}) is not yet ported "
            "to sharetrade_tpu_torch; only models with the precomputed-trunk "
            "pair (the episode transformer) train")
    return _collect_rollout_precomputed(model, env, ts, unroll_len,
                                        num_agents, params=params,
                                        gumbel=gumbel, marker=marker)


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
            env_state = type(env_state)(*[
                torch.where(mask, new, old)
                for new, old in zip(stepped.leaves(), env_state.leaves())])
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


def replay_forward(model: Model, params: Any, traj: StepData, init_carry):
    """Recompute ``(logits (T, B, A), values (T, B), aux)`` along a stored
    trajectory under ``params`` — the differentiable forward of the loss:
    the shared-trunk replay when the model has it, else the per-agent
    banded replay."""
    if model.apply_unroll_shared is not None:
        return model.apply_unroll_shared(params, traj.obs, init_carry)
    if model.apply_unroll is not None:
        return model.apply_unroll(params, traj.obs, init_carry)
    raise ConfigError(f"replay of {model.name} (folded or scanned) is not "
                      "yet ported to sharetrade_tpu_torch")


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
