"""Multi-asset portfolio trading environment.

Counterpart of the JAX package's ``env/portfolio.py``: A assets trade
against one shared budget, and at A = 1 the env is exactly the single-asset
one (``env/trading.py``).

- Observation: the A price windows side by side (A x window floats), then
  the budget, then the A share counts: ``obs_dim = A·window + 1 + A``.
- Actions: ``2A + 1`` choices — ``a`` in [0, A) buys one share of asset a,
  ``a`` in [A, 2A) sells one share of asset ``a - A``, ``2A`` holds (at
  A = 1 the reference's Buy, Sell, Hold).
- Each trade follows the single-asset rules for the traded asset: a buy
  iff the budget covers its price, a sell iff a share is held, else a
  hold. Trades execute at ``prices[:, t + window]``; the reward is the
  portfolio's change, shares marked at the last trade prices (0 before the
  first).

The state is an :class:`~sharetrade_tpu_torch.env.trading.EnvState` with
the JAX ``PortfolioState``'s fields: ``t`` and ``budget`` of the batch's
leading shape, ``shares`` and ``share_value`` with a trailing asset axis
(B, A). Every function is elementwise over the leading shape, with no
branch on a tensor's value.
"""

from __future__ import annotations

import torch

from sharetrade_tpu_torch.device import resolve_device
from sharetrade_tpu_torch.env.core import TradingEnv
from sharetrade_tpu_torch.env.trading import EnvState


def make_portfolio_env(prices, window: int = 201,
                       initial_budget: float = 2400.0, initial_shares=None,
                       *, device: torch.device | str | None = None
                       ) -> TradingEnv:
    """A multi-asset env over ``prices`` (A, T) (or (T,) for one asset) on
    ``device`` (``cuda`` when None; raises without one)."""
    device = resolve_device(device)
    prices = torch.as_tensor(prices, dtype=torch.float32).to(device)
    if prices.ndim == 1:
        prices = prices[None, :]
    if prices.ndim != 2:
        raise ValueError(f"prices must be (A, T), got {tuple(prices.shape)}")
    num_assets, total = int(prices.shape[0]), int(prices.shape[1])
    if total <= window:
        raise ValueError(
            f"price count ({total}) must exceed the window ({window})")
    shares0 = torch.zeros((num_assets,), device=device)
    if initial_shares is not None:
        shares0 = shares0 + torch.as_tensor(initial_shares,
                                            dtype=torch.float32).to(device)
    offsets = torch.arange(window, device=device)

    def reset() -> EnvState:
        return EnvState(
            t=torch.zeros((), dtype=torch.int32, device=device),
            budget=torch.tensor(float(initial_budget), device=device),
            shares=shares0.clone(),
            share_value=torch.zeros((num_assets,), device=device))

    def observe(state: EnvState) -> torch.Tensor:
        idx = state.t.long()[..., None] + offsets                 # (..., W)
        windows = prices[:, idx].movedim(0, -2)                   # (..., A, W)
        return torch.cat([windows.flatten(-2), state.budget[..., None],
                          state.shares], dim=-1)

    def portfolio_value(state: EnvState) -> torch.Tensor:
        return state.budget + (state.shares * state.share_value).sum(dim=-1)

    def step(state: EnvState, action: torch.Tensor):
        # Clamped as JAX clamps an out-of-range gather (a frozen row at the
        # horizon; the learner masks its step).
        cursor = torch.clamp(state.t.long() + window, max=total - 1)
        trade_prices = prices[:, cursor].movedim(0, -1)           # (..., A)
        is_buy = action < num_assets
        is_sell = (action >= num_assets) & (action < 2 * num_assets)
        asset = torch.where(is_buy, action, torch.where(
            is_sell, action - num_assets, torch.zeros_like(action)))
        onehot = torch.nn.functional.one_hot(asset, num_assets).float()
        price_a = trade_prices.gather(-1, asset[..., None])[..., 0]
        held = state.shares.gather(-1, asset[..., None])[..., 0]
        can_buy = is_buy & (state.budget >= price_a)
        can_sell = is_sell & (held > 0)
        delta = can_buy.float() - can_sell.float()   # 1 buy, -1 sell, 0 hold
        new_budget = state.budget - delta * price_a
        new_shares = state.shares + delta[..., None] * onehot
        new_portfolio = new_budget + (new_shares * trade_prices).sum(dim=-1)
        reward = new_portfolio - portfolio_value(state)
        return EnvState(t=state.t + 1, budget=new_budget, shares=new_shares,
                        share_value=trade_prices), reward

    return TradingEnv(
        reset=reset, observe=observe, step=step,
        portfolio_value=portfolio_value, num_steps=total - window,
        obs_dim=num_assets * window + 1 + num_assets,
        num_actions=2 * num_assets + 1, num_assets=num_assets)
