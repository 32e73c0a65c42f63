"""Deterministic synthetic price series.

The reference ships a 6,046-line MSFT daily-close CSV as its market-data
fixture (src/main/resources/MSFT-stock-prices-revised.txt, SURVEY.md §2.1 #7).
That file is not copied here; when no CSV is configured, a seeded geometric
random walk of the same length/scale stands in, so episode shape (and therefore
benchmark comparability: 6,046 prices -> 5,845 scan steps) is preserved.
"""

from __future__ import annotations

import numpy as np

from sharetrade_tpu_torch.data.ingest import PriceSeries


def synthetic_price_series(
    symbol: str = "SYNTH",
    length: int = 6046,
    seed: int = 1992,
    start_date: str = "1992-07-22",
    initial_price: float = 56.08,
) -> PriceSeries:
    rng = np.random.default_rng(seed)
    # Geometric random walk with mild drift — daily-close-like dynamics.
    log_returns = rng.normal(loc=0.0002, scale=0.02, size=length - 1)
    prices = initial_price * np.exp(np.concatenate([[0.0], np.cumsum(log_returns)]))
    prices = np.maximum(prices.astype(np.float32), 0.01)
    # Business-day-ish calendar: consecutive days, weekends skipped.
    days = np.arange(length) + (np.arange(length) // 5) * 2
    dates = np.datetime64(start_date) + days.astype("timedelta64[D]")
    return PriceSeries(symbol, dates.astype("datetime64[D]"), prices)
