"""Trading environments: the single-asset one (``trading.py``) and the
multi-asset portfolio (``portfolio.py``), behind ``core.TradingEnv``."""
