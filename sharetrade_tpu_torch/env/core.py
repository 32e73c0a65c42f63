"""Environment interface: what every trading environment exposes to agents.

Counterpart of the JAX package's ``env/core.py``: a bundle of plain functions
that close over the (static) price data. The JAX package maps one agent's
functions over the agent batch with ``vmap``; here the batch is a leading
dimension that every function takes as it comes — ``reset()`` gives one
agent's state (0-d tensors), and ``observe``/``step``/``portfolio_value``
work on a state of any leading shape.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch


@dataclass(frozen=True)
class TradingEnv:
    """A trading environment as functions + static shape facts."""

    reset: Callable[[], Any]                        # () -> EnvState
    observe: Callable[[Any], torch.Tensor]          # state -> (..., obs_dim)
    step: Callable[[Any, torch.Tensor], tuple[Any, torch.Tensor]]
    portfolio_value: Callable[[Any], torch.Tensor]
    num_steps: int                                  # episode horizon
    obs_dim: int
    num_actions: int
    num_assets: int = 1
    # Price-injected step: the same transition with the trade price passed
    # in (a 0-d tensor shared by every agent) instead of gathered by cursor;
    # the precomputed rollout uses it (agents/rollout.py).
    step_priced: Callable[[Any, torch.Tensor, torch.Tensor],
                          tuple[Any, torch.Tensor]] | None = None
