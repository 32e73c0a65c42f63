"""Learners.

Counterpart of the JAX package's ``agents/__init__.py``: the five learners
(``learner.algo``) behind one ``build_agent``. The value-based ones
(``qlearn``, ``dqn``) drive a Q-head and need ``model.kind="mlp"``; the
others drive actor-critic heads. Under ``learner.journal_replay`` the DQN
agent returns each chunk's transitions (``collect_transitions``), which the
orchestrator journals.
"""

from __future__ import annotations

from sharetrade_tpu_torch.agents.a2c import make_a2c_agent
from sharetrade_tpu_torch.agents.base import (  # noqa: F401
    Agent, TrainState, build_optimizer, epsilon_greedy, exploit_probability,
    portfolio_metrics)
from sharetrade_tpu_torch.agents.dqn import make_dqn_agent
from sharetrade_tpu_torch.agents.pg import make_pg_agent
from sharetrade_tpu_torch.agents.ppo import make_ppo_agent
from sharetrade_tpu_torch.agents.qlearn import make_qlearn_agent
from sharetrade_tpu_torch.config import FrameworkConfig
from sharetrade_tpu_torch.env.core import TradingEnv
from sharetrade_tpu_torch.models import build_model
from sharetrade_tpu_torch.models.core import Model
from sharetrade_tpu_torch.precision import policy_from_config

_FACTORIES = {
    "qlearn": make_qlearn_agent,
    "pg": make_pg_agent,
    "dqn": make_dqn_agent,
    "a2c": make_a2c_agent,
    "ppo": make_ppo_agent,
}

#: Value-based algorithms drive a Q-head; the rest are actor-critic.
_HEADS = {"qlearn": "q", "dqn": "q", "pg": "ac", "a2c": "ac", "ppo": "ac"}


def build_agent(cfg: FrameworkConfig, env: TradingEnv,
                model: Model | None = None, *, device=None) -> Agent:
    """Wire model + env + learner from a framework config, on ``device``
    (``cuda`` when None; the env's prices must live there too)."""
    algo = cfg.learner.algo
    if algo not in _FACTORIES:
        raise ValueError(f"unknown learner.algo {algo!r}; "
                         f"choose from {sorted(_FACTORIES)}")
    if _HEADS[algo] == "q" and cfg.model.kind != "mlp":
        raise ValueError(
            f"learner.algo={algo!r} requires model.kind='mlp' (got "
            f"{cfg.model.kind!r}); use a2c/ppo for {cfg.model.kind} policies")
    if model is None:
        model = build_model(cfg.model, env.obs_dim, head=_HEADS[algo],
                            device=device, num_actions=env.num_actions,
                            num_assets=env.num_assets)
    extra = ({"collect_transitions": cfg.learner.journal_replay}
             if algo == "dqn" else {})
    return _FACTORIES[algo](
        model, env, cfg.learner, num_agents=cfg.parallel.num_workers,
        steps_per_chunk=cfg.runtime.chunk_steps,
        precision=policy_from_config(cfg.precision), **extra)
