"""Market-data ingestion: CSV parsing and date-range queries.

Reference behavior (SharePriceGetter.scala:83-102): parse `price, date` CSV
lines, drop malformed rows, return a date-sorted map. The reference *ignores*
its stock-name/date-range arguments and always returns the whole file; its own
spec (SharePriceGetterSpec.scala) documents range filtering as the intended
behavior — so range filtering is implemented for real here (SURVEY.md §4).

Prices are kept as parallel numpy arrays (dates as ``datetime64[D]``, prices as
``float32``) rather than a per-row map: the training path consumes the whole
series as one device array (SURVEY.md §7.2), so columnar layout is the natural
host-side format.
"""

from __future__ import annotations

from dataclasses import dataclass
from datetime import date
from typing import Iterable

import numpy as np

from sharetrade_tpu_torch.utils.logging import get_logger

log = get_logger("data.ingest")


@dataclass(frozen=True)
class PriceSeries:
    """A date-sorted price history for one symbol."""

    symbol: str
    dates: np.ndarray   # datetime64[D], ascending, unique
    prices: np.ndarray  # float32, same length

    def __post_init__(self) -> None:
        if self.dates.shape != self.prices.shape:
            raise ValueError("dates and prices must have equal length")

    def __len__(self) -> int:
        return int(self.dates.shape[0])

    def range(self, start: date | str | None = None, end: date | str | None = None) -> "PriceSeries":
        """Rows with start <= date <= end (inclusive, either bound optional)."""
        mask = np.ones(len(self), dtype=bool)
        if start is not None:
            mask &= self.dates >= np.datetime64(str(start))
        if end is not None:
            mask &= self.dates <= np.datetime64(str(end))
        return PriceSeries(self.symbol, self.dates[mask], self.prices[mask])

    def merge_keep_old(self, newer: "PriceSeries") -> "PriceSeries":
        """Merge in newly fetched rows; on date collisions the *existing* value
        wins — the reference's cache-update rule (SharePriceGetter.scala:64-73,
        `updateStockMapIfTheresChange`: old values win collisions)."""
        if newer.symbol != self.symbol:
            raise ValueError(f"cannot merge {newer.symbol!r} into {self.symbol!r}")
        fresh = ~np.isin(newer.dates, self.dates)
        dates = np.concatenate([self.dates, newer.dates[fresh]])
        prices = np.concatenate([self.prices, newer.prices[fresh]])
        order = np.argsort(dates, kind="stable")
        return PriceSeries(self.symbol, dates[order], prices[order])

    def to_dict(self) -> dict:
        return {
            "symbol": self.symbol,
            "dates": [str(d) for d in self.dates.astype("datetime64[D]")],
            "prices": [float(p) for p in self.prices],
        }

    @classmethod
    def from_dict(cls, d: dict) -> "PriceSeries":
        return from_rows(d["symbol"], zip(d["dates"], d["prices"]))


def from_rows(symbol: str, rows: Iterable[tuple[str, float]]) -> PriceSeries:
    # Dedupe dates with first-occurrence-wins, enforcing the "old value wins"
    # collision rule within a single fetch too (same contract as merge_keep_old).
    seen: dict[np.datetime64, float] = {}
    for ds, p in rows:
        key = np.datetime64(ds)
        if key not in seen:
            seen[key] = float(p)
    pairs = sorted(seen.items())
    if pairs:
        dates = np.array([d for d, _ in pairs], dtype="datetime64[D]")
        prices = np.array([p for _, p in pairs], dtype=np.float32)
    else:
        dates = np.empty(0, dtype="datetime64[D]")
        prices = np.empty(0, dtype=np.float32)
    return PriceSeries(symbol, dates, prices)


def parse_price_lines(symbol: str, lines: Iterable[str]) -> PriceSeries:
    """Parse `price, date` lines (e.g. ``56.080002, 1992-07-22``).

    Malformed rows are dropped, matching the reference's lenient parse
    (SharePriceGetter.scala:92-100 drops rows that fail the pattern match).
    """
    rows: list[tuple[str, float]] = []
    dropped = 0
    for line in lines:
        parts = [p.strip() for p in line.strip().split(",")]
        if len(parts) != 2:
            dropped += 1
            continue
        price_s, date_s = parts
        try:
            price = float(price_s)
            np.datetime64(date_s)  # validates ISO date
        except (ValueError, TypeError):
            dropped += 1
            continue
        rows.append((date_s, price))
    if dropped:
        log.debug("dropped %d malformed rows for %s", dropped, symbol)
    return from_rows(symbol, rows)


def load_price_csv(path: str, symbol: str = "MSFT") -> PriceSeries:
    with open(path) as f:
        return parse_price_lines(symbol, f)


def align_series(series_list: list[PriceSeries]) -> np.ndarray:
    """Stack multiple symbols into an (A, T) price matrix over their common
    trading dates — the multi-asset portfolio env's input. Dates present in
    only some series are dropped (inner join), preserving order."""
    if not series_list:
        raise ValueError("align_series of empty list")
    common = series_list[0].dates
    for s in series_list[1:]:
        common = common[np.isin(common, s.dates)]
    if common.size == 0:
        raise ValueError(
            f"no common dates across {[s.symbol for s in series_list]}")
    rows = []
    for s in series_list:
        idx = np.searchsorted(s.dates, common)
        rows.append(s.prices[idx])
    return np.stack(rows)
