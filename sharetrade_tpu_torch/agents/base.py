"""Learner interface and shared RL machinery.

Counterpart of the JAX package's ``agents/base.py``. Every learner exposes
``init(seed) -> TrainState`` and ``step(TrainState) -> (TrainState,
metrics)``, where one step advances ``steps_per_chunk`` env steps for the
whole agent batch and runs the learning update. The JAX package compiles
that step into one program; here it runs eagerly on the device, and the
orchestrator reads its metrics back once per chunk.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Callable, NamedTuple

import torch

from sharetrade_tpu_torch.config import LearnerConfig
from sharetrade_tpu_torch.env.core import TradingEnv
from sharetrade_tpu_torch.models.core import rows_finite
from sharetrade_tpu_torch.ops.fused_update import (
    OPTIMIZERS, fused_apply, init_state)
from sharetrade_tpu_torch.precision import FP32, PrecisionPolicy


@dataclass
class TrainState:
    """Everything a learner threads between chunks: parameters, optimizer
    state, the batched model carry and env state, the random generator and
    the counters (``env_steps``, ``updates``: int32 device scalars)."""

    params: Any
    opt_state: Any
    carry: Any               # (B, ...) model recurrent state
    env_state: Any           # batched EnvState
    rng: torch.Generator
    env_steps: torch.Tensor
    updates: torch.Tensor

    def replace(self, **changes) -> "TrainState":
        return replace(self, **changes)


@dataclass(frozen=True)
class Agent:
    """A learner: ``init``/``step`` plus static shape facts."""

    name: str
    init: Callable[[int], TrainState]
    step: Callable[..., tuple[TrainState, dict[str, torch.Tensor]]]
    num_agents: int
    steps_per_chunk: int
    model: Any = None
    # (compute params, traj_mb, carry_mb, adv_mb, ret_mb) -> (loss terms,
    # grads): one minibatch's loss and gradients, as ``step`` computes them
    # (``chip_smoke.py`` holds the kernels' gradients against the plain
    # attention's with it).
    minibatch_grads: Callable | None = None


class Optimizer(NamedTuple):
    """The optimizer a learner applies: its name and learning rate, and the
    optax-shaped initial state (``ops/fused_update.init_state``)."""

    name: str
    learning_rate: float

    def init(self, params: Any) -> tuple:
        return init_state(self.name, params)


def build_optimizer(cfg: LearnerConfig) -> Optimizer:
    """adagrad (optax's default ``initial_accumulator_value=0.1``, TF's
    AdaGrad), adam or sgd at ``cfg.learning_rate``."""
    if cfg.optimizer not in OPTIMIZERS:
        raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
    return Optimizer(cfg.optimizer, float(cfg.learning_rate))


def make_update_fn(optimizer: Optimizer, precision: PrecisionPolicy = FP32):
    """The optimizer-update seam every learner applies its gradients
    through: ``update(grads, opt_state, params) -> (params, opt_state,
    compute)``, where ``compute`` is the copy of the updated masters the
    next forward and backward run on.

    ``grads`` arrive in whatever dtype the loss backward produced (bf16
    under ``bf16_mixed``: differentiation runs against the compute copy);
    the fused pass upcasts them, and under ``bf16_mixed`` writes the next
    bf16 compute copy in the same pass (``emit_compute``); in fp32 the
    compute copy is the masters themselves. Every ``precision.fused_update``
    setting routes through ``ops/fused_update.fused_apply``: the JAX package
    pins the optax pair and the fused pass bit-identical in fp32
    (tests/test_precision.py), and the port has no optax. The update is IN
    PLACE: the master parameters and the moments are written where they
    were read, and the same objects are returned."""
    name, lr = optimizer.name, optimizer.learning_rate

    if precision.mixed:
        def update(grads, opt_state, params):
            return fused_apply(name, lr, grads, opt_state, params,
                               emit_compute=True)
    else:
        def update(grads, opt_state, params):
            params, opt_state = fused_apply(name, lr, grads, opt_state, params)
            return params, opt_state, params

    return update


def batched_reset(env: TradingEnv, num_agents: int):
    """One reset state broadcast over the agent batch (views: rows share
    storage until a step writes new tensors)."""
    return env.reset().map(lambda x: x.expand((num_agents,) + x.shape))


def batched_carry(model, num_agents: int) -> dict:
    carry = model.init_carry()
    return {k: v.expand((num_agents,) + v.shape) for k, v in carry.items()}


def healthy_mask(obs: torch.Tensor) -> torch.Tensor:
    """(B, obs_dim) -> (B,) bool: rows that are entirely finite."""
    return torch.isfinite(obs).all(dim=-1)


def agent_health(env_state) -> torch.Tensor:
    """(B,) bool: True where every env-state field row is finite."""
    leaves = env_state.leaves()
    b = leaves[0].shape[0]
    ok = torch.ones((b,), dtype=torch.bool, device=leaves[0].device)
    for leaf in leaves:
        ok = ok & torch.isfinite(leaf).reshape(b, -1).all(dim=-1)
    return ok


def election_health(env_state, carry) -> torch.Tensor:
    """(B,) bool: the row predicate of the representative election — env
    state AND model carry rows finite (a finite wallet with a NaN K/V cache
    must never be elected: its carry would feed every agent's trunk)."""
    ok = agent_health(env_state)
    return ok & rows_finite(carry, ok.shape[0])


def quarantine_mask(obs_raw: torch.Tensor, env_state) -> torch.Tensor:
    """The learner-side quarantine predicate: a row is healthy iff its
    observation AND its whole env-state row are finite."""
    return healthy_mask(obs_raw) & agent_health(env_state)


def portfolio_metrics(env: TradingEnv, env_state) -> dict[str, torch.Tensor]:
    """Mean/std over HEALTHY agents' portfolios (progressive), the same over
    agents whose cursor reached the horizon (``*_trained``, the reference's
    GetAvg observable), and the counts behind them."""
    values = env.portfolio_value(env_state)
    fine = agent_health(env_state).float()
    values = torch.where(fine > 0, values, torch.zeros_like(values))
    n_fine = torch.clamp(fine.sum(), min=1.0)
    mean = (values * fine).sum() / n_fine
    var = (fine * (values - mean) ** 2).sum() / n_fine
    done = fine * (env_state.t >= env.num_steps).float()
    n_done = done.sum()
    safe_n = torch.clamp(n_done, min=1.0)
    mean_t = (values * done).sum() / safe_n
    var_t = (done * (values - mean_t) ** 2).sum() / safe_n
    big = torch.finfo(torch.float32).max
    return {
        "portfolio_mean": mean,
        "portfolio_std": torch.sqrt(var),
        "portfolio_min": torch.where(fine > 0, values,
                                     torch.full_like(values, big)).min(),
        "portfolio_max": torch.where(fine > 0, values,
                                     torch.full_like(values, -big)).max(),
        "portfolio_mean_trained": mean_t,
        "portfolio_std_trained": torch.sqrt(var_t),
        "trained_workers": n_done,
        "unhealthy_workers": values.shape[0] - fine.sum(),
    }

