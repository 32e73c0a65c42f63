"""Price data service: ``request(symbol, start, end)`` over a provider.

Counterpart of the JAX package's ``data/service.py`` with only what serving
needs: the CSV provider (``data.csv_path``) and the seeded synthetic provider,
behind an in-memory per-symbol cache. The synthetic provider derives each
symbol's seed exactly as the JAX package does (``seed + crc32(symbol) %
65536``), so both packages serve the same prices for the same config.

Not yet ported: the event journal and its recovery/compaction, the HTTP
provider, and streaming feeds (``tail``). A config that asks for the HTTP
provider or a feed is refused rather than served from another source.
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass
from datetime import date
from typing import Callable

from sharetrade_tpu_torch.config import ConfigError, DataConfig
from sharetrade_tpu_torch.data.ingest import PriceSeries, load_price_csv
from sharetrade_tpu_torch.data.synthetic import synthetic_price_series
from sharetrade_tpu_torch.utils.logging import get_logger

log = get_logger("data.service")


@dataclass(frozen=True)
class StockDataResponse:
    symbol: str
    series: PriceSeries


def csv_provider(path: str) -> Callable[..., PriceSeries]:
    def fetch(symbol: str, start=None, end=None) -> PriceSeries:
        return load_price_csv(path, symbol=symbol)
    return fetch


def synthetic_provider(length: int = 6046,
                       seed: int = 1992) -> Callable[..., PriceSeries]:
    def fetch(symbol: str, start=None, end=None) -> PriceSeries:
        sym_seed = seed + (zlib.crc32(symbol.encode()) % 65536)
        return synthetic_price_series(symbol=symbol, length=length,
                                      seed=sym_seed)
    return fetch


class PriceDataService:
    """Cached price lookups; the full history is fetched once per symbol and
    only the reply is range-filtered (inclusive bounds)."""

    def __init__(self, provider: Callable[..., PriceSeries] | None = None,
                 config: DataConfig | None = None):
        cfg = config or DataConfig()
        if cfg.http_url:
            raise ConfigError("data.http_url: the HTTP provider is not yet "
                              "ported to sharetrade_tpu_torch")
        if cfg.feed_path:
            raise ConfigError("data.feed_path: streaming feeds are not yet "
                              "ported to sharetrade_tpu_torch")
        if provider is None:
            provider = (csv_provider(cfg.csv_path) if cfg.csv_path
                        else synthetic_provider(cfg.synthetic_length,
                                                cfg.synthetic_seed))
        self._provider = provider
        self._cache: dict[str, PriceSeries] = {}

    def request(self, symbol: str, start: date | str | None = None,
                end: date | str | None = None) -> StockDataResponse:
        if symbol not in self._cache:
            self._cache[symbol] = self._provider(symbol, None, None)
        else:
            log.debug("cache hit for %s", symbol)
        return StockDataResponse(symbol, self._cache[symbol].range(start, end))
