"""Learners.

Counterpart of the JAX package's ``agents/__init__.py``. Only PPO on the
episode-mode transformer is ported so far; every other learner raises a
``ConfigError`` instead of training something else.
"""

from __future__ import annotations

from sharetrade_tpu_torch.agents.base import (  # noqa: F401
    Agent, TrainState, build_optimizer, portfolio_metrics)
from sharetrade_tpu_torch.agents.ppo import make_ppo_agent
from sharetrade_tpu_torch.config import ConfigError, FrameworkConfig
from sharetrade_tpu_torch.env.core import TradingEnv
from sharetrade_tpu_torch.models import build_model
from sharetrade_tpu_torch.models.core import Model
from sharetrade_tpu_torch.precision import policy_from_config

_ALGOS = ("qlearn", "pg", "dqn", "a2c", "ppo")


def build_agent(cfg: FrameworkConfig, env: TradingEnv,
                model: Model | None = None, *, device=None) -> Agent:
    """Wire model + env + learner from a framework config, on ``device``
    (``cuda`` when None; the env's prices must live there too)."""
    algo = cfg.learner.algo
    if algo not in _ALGOS:
        raise ValueError(f"unknown learner.algo {algo!r}; "
                         f"choose from {sorted(_ALGOS)}")
    if algo != "ppo":
        raise ConfigError(f"learner.algo={algo!r} is not yet ported to "
                          "sharetrade_tpu_torch; only 'ppo' is")
    if model is None:
        model = build_model(cfg.model, env.obs_dim, device=device)
    return make_ppo_agent(
        model, env, cfg.learner, num_agents=cfg.parallel.num_workers,
        steps_per_chunk=cfg.runtime.chunk_steps,
        precision=policy_from_config(cfg.precision))
