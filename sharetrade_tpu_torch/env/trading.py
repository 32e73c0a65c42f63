"""The single-asset windowed share-trading environment.

Counterpart of the JAX package's ``env/trading.py``; the semantics are the
same, line for line:

- Observation at step ``t``: the ``window`` prices ``prices[t .. t+window-1]``
  (oldest first), then the budget and the share count — ``window + 2``
  floats.
- The trade executes at ``prices[t + window]``, the price just after the
  window. Buy is feasible iff ``budget >= price`` (budget -= price, shares
  += 1); Sell iff ``shares > 0`` (budget += price, shares -= 1). An
  infeasible Buy or Sell degrades to Hold.
- Reward = new portfolio - current portfolio, where portfolio = budget +
  shares x share_value and share_value is the PREVIOUS step's trade price
  (0 before the first trade, so the first portfolio is the budget).
- Episode length = ``len(prices) - window`` steps.

Where the JAX package maps one agent's functions over the batch with
``vmap``, here an :class:`EnvState` holds tensors of any leading shape (0-d
for one agent, ``(B,)`` for a batch) and every function is elementwise over
it, with no branch on a tensor's value.
"""

from __future__ import annotations

from dataclasses import dataclass, fields, replace

import torch

from sharetrade_tpu_torch.device import resolve_device
from sharetrade_tpu_torch.env.core import TradingEnv

BUY, SELL, HOLD = 0, 1, 2  # reference action order: actions = Seq(Buy, Sell, Hold)
NUM_ACTIONS = 3


def obs_dim(window: int) -> int:
    """Observation width for a price window: prices + budget + shares."""
    return window + 2


@dataclass(frozen=True)
class EnvParams:
    """Static episode data: the price series plus initial conditions."""

    prices: torch.Tensor             # (T,) float32
    initial_budget: float
    initial_shares: float
    window: int = 201


@dataclass(frozen=True)
class EnvState:
    """Per-agent state (the fold carry); fields share one leading shape."""

    t: torch.Tensor             # int32 step cursor
    budget: torch.Tensor        # float32
    shares: torch.Tensor        # float32 (integer-valued)
    share_value: torch.Tensor   # float32 last trade price (0 before a trade)

    def map(self, fn) -> "EnvState":
        """A state whose every field is ``fn(field)``."""
        return EnvState(**{f.name: fn(getattr(self, f.name))
                           for f in fields(self)})

    def replace(self, **changes) -> "EnvState":
        return replace(self, **changes)

    def leaves(self) -> list[torch.Tensor]:
        return [getattr(self, f.name) for f in fields(self)]


def env_from_prices(prices, window: int = 201, initial_budget: float = 2400.0,
                    initial_shares: int = 0, *,
                    device: torch.device | str | None = None) -> EnvParams:
    """The episode data on ``device`` (``cuda`` when None; raises without
    one)."""
    prices = torch.as_tensor(prices, dtype=torch.float32).to(
        resolve_device(device))
    if prices.ndim != 1:
        raise ValueError(f"prices must be 1-D, got shape {tuple(prices.shape)}")
    if prices.shape[0] <= window:
        # Exactly window + 1 prices is a valid one-step episode.
        raise ValueError(f"price count ({prices.shape[0]}) must exceed the "
                         f"window ({window})")
    return EnvParams(prices=prices, initial_budget=float(initial_budget),
                     initial_shares=float(initial_shares), window=window)


def num_steps(params: EnvParams) -> int:
    """Steps per episode: len(prices) - window."""
    return int(params.prices.shape[0]) - params.window


def reset(params: EnvParams) -> EnvState:
    device = params.prices.device
    return EnvState(
        t=torch.zeros((), dtype=torch.int32, device=device),
        budget=torch.tensor(params.initial_budget, dtype=torch.float32,
                            device=device),
        shares=torch.tensor(params.initial_shares, dtype=torch.float32,
                            device=device),
        share_value=torch.zeros((), dtype=torch.float32, device=device))


def observe(params: EnvParams, state: EnvState) -> torch.Tensor:
    """``prices[t : t+window] ++ (budget, shares)``: shape (..., window+2)."""
    offsets = torch.arange(params.window, device=state.t.device)
    window_slice = params.prices[state.t.long()[..., None] + offsets]
    return torch.cat([window_slice, state.budget[..., None],
                      state.shares[..., None]], dim=-1)


def portfolio_value(state: EnvState) -> torch.Tensor:
    """budget + shares x last trade price."""
    return state.budget + state.shares * state.share_value


def step(params: EnvParams, state: EnvState, action: torch.Tensor,
         trade_price: torch.Tensor | None = None
         ) -> tuple[EnvState, torch.Tensor]:
    """Apply one action per agent; returns ``(new_state, reward)``.
    ``trade_price`` overrides the by-cursor gather (a tensor that
    broadcasts against the state: the precomputed rollout passes one 0-d
    price for the whole lockstep batch)."""
    if trade_price is None:
        # Clamped as JAX clamps an out-of-range gather: a row at the horizon
        # (frozen, its step masked by the learner) reads the last price.
        trade_price = params.prices[torch.clamp(
            state.t.long() + params.window, max=params.prices.shape[0] - 1)]
    can_buy = (action == BUY) & (state.budget >= trade_price)
    can_sell = (action == SELL) & (state.shares > 0)
    delta = can_buy.float() - can_sell.float()      # 1 buy, -1 sell, 0 hold
    new_budget = state.budget - delta * trade_price
    new_shares = state.shares + delta
    current_portfolio = portfolio_value(state)
    new_portfolio = new_budget + new_shares * trade_price
    reward = new_portfolio - current_portfolio
    new_state = EnvState(t=state.t + 1, budget=new_budget, shares=new_shares,
                         share_value=trade_price.expand_as(new_budget))
    return new_state, reward


def make_trading_env(prices, window: int = 201, initial_budget: float = 2400.0,
                     initial_shares: int = 0, *,
                     device: torch.device | str | None = None) -> TradingEnv:
    """Bundle the single-asset functions into the :class:`TradingEnv`
    interface, closing over the price series on ``device`` (``cuda`` when
    None)."""
    params = env_from_prices(prices, window=window,
                             initial_budget=initial_budget,
                             initial_shares=initial_shares, device=device)
    return TradingEnv(
        reset=lambda: reset(params),
        observe=lambda s: observe(params, s),
        step=lambda s, a: step(params, s, a),
        portfolio_value=portfolio_value,
        num_steps=num_steps(params),
        obs_dim=params.window + 2,
        num_actions=NUM_ACTIONS,
        num_assets=1,
        step_priced=lambda s, a, p: step(params, s, a, trade_price=p),
    )
