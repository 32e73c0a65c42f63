"""Trading environments: the single-asset one (``trading.py``) and the
multi-asset portfolio (``portfolio.py``), behind ``core.TradingEnv``."""

from __future__ import annotations


def make_env(env_cfg, prices, device):
    """The env a learner trains over ``prices`` with ``env_cfg`` (an
    ``EnvConfig``): the multi-asset portfolio for an (A, T) matrix with
    A > 1, else the single-asset env."""
    import numpy as np

    from sharetrade_tpu_torch.env.portfolio import make_portfolio_env
    from sharetrade_tpu_torch.env.trading import make_trading_env
    prices = np.asarray(prices)
    kw = dict(window=env_cfg.window, initial_budget=env_cfg.initial_budget,
              initial_shares=env_cfg.initial_shares, device=device)
    if prices.ndim == 2 and prices.shape[0] > 1:
        return make_portfolio_env(prices, **kw)
    return make_trading_env(prices.reshape(-1), **kw)
