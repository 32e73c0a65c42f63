"""Event-sourced price data service (the L1 layer).

Counterpart of the JAX package's ``data/service.py``, whole: the same
providers (CSV, HTTP, seeded synthetic), streaming feeds, the price-event
journal with recovery and compaction. Both packages journal to
``<data.journal_dir>/price-events.journal`` in one format (``data/journal.py``)
and write the same bytes for the same fetches, so either recovers the
other's cache; the writer lock refuses a second live writer of one path.
The JAX package takes its C++ journal backend when ``native/libstjournal.so``
is built; the port has the pure-Python journal only, so
``data.use_native_journal`` (and, in the orchestrator,
``data.async_transition_writer``) run on it, with the same on-disk format.

Reference: ``SharePriceGetter`` — a PersistentActor that serves
``RequestStockPrice(stock, from, to)`` with a date-sorted price map, caches
results in memory, persists fetch events to a LevelDB journal, and rebuilds the
cache by replaying events on restart (SharePriceGetter.scala:21-73).

Here the same contract is a plain object:

- ``request(symbol, start, end)`` -> ``StockDataResponse`` with the range
  actually filtered (the reference's *intended* behavior per its spec;
  its implementation ignores the range — SURVEY.md §4, SharePriceGetterSpec).
- Fetches go through a pluggable ``provider`` (CSV file, HTTP, or the
  synthetic generator standing in for a market-data API, as the reference
  "fakes a http query", SharePriceGetter.scala:83).
- Every fetch is appended to the journal; construction replays the journal
  into the in-memory cache (event-sourcing recovery).
- Cache merges keep old values on date collisions (reference
  ``updateStockMapIfTheresChange`` semantics).
"""

from __future__ import annotations

import os
import zlib
from dataclasses import dataclass
from datetime import date
from typing import Callable, Protocol

from sharetrade_tpu_torch.config import DataConfig
from sharetrade_tpu_torch.data.ingest import PriceSeries, load_price_csv
from sharetrade_tpu_torch.data.journal import Journal
from sharetrade_tpu_torch.data.synthetic import synthetic_price_series
from sharetrade_tpu_torch.utils.logging import get_logger

log = get_logger("data.service")


@dataclass(frozen=True)
class StockDataResponse:
    """Reply shape of the reference's protocol
    (SharePriceGetter.scala:15: StockDataResponse(stockName, TreeMap))."""

    symbol: str
    series: PriceSeries


class PriceProvider(Protocol):
    def __call__(self, symbol: str, start: date | str | None, end: date | str | None) -> PriceSeries: ...


def csv_provider(path: str) -> Callable[..., PriceSeries]:
    def fetch(symbol: str, start=None, end=None) -> PriceSeries:
        return load_price_csv(path, symbol=symbol)
    return fetch


def http_provider(url_template: str, *,
                  timeout: float = 30.0) -> Callable[..., PriceSeries]:
    """Fetch ``price, date`` CSV rows over HTTP — the market-data API the
    reference only pretends to call (``queryData`` is documented as "faking
    a http query" while reading a classpath file,
    SharePriceGetter.scala:83-102). ``url_template`` may carry a
    ``{symbol}`` placeholder, e.g. ``http://quotes.internal/prices/{symbol}.csv``.

    Responses parse through the same line parser as local CSV files
    (data/ingest.py ``parse_price_lines``: bad rows dropped, date-sorted),
    so the two sources are byte-interchangeable; fetch failures raise
    (urllib.error) and surface through the service's caller.

    Only http/https URLs are accepted (urlopen would happily serve
    ``file://`` — a config-injection path into the price cache/journal) and
    the response body is capped at ``max_bytes`` so a hostile or
    misconfigured endpoint can't balloon host memory."""
    from urllib.parse import quote, urlsplit
    from urllib.request import urlopen

    from sharetrade_tpu_torch.data.ingest import parse_price_lines

    max_bytes = 64 * 1024 * 1024   # 64 MiB ≈ 3000 years of daily closes

    scheme = urlsplit(url_template).scheme.lower()
    if scheme not in ("http", "https"):
        raise ValueError(
            f"http_provider requires an http(s) URL, got scheme {scheme!r} "
            f"in {url_template!r}")

    def fetch(symbol: str, start=None, end=None) -> PriceSeries:
        # quote() so symbols with spaces/slashes ('BRK B', 'NYSE/BRK.A')
        # can't break the path; replace() not format() so templates may
        # contain other literal braces.
        url = url_template.replace("{symbol}", quote(symbol, safe=""))
        with urlopen(url, timeout=timeout) as resp:
            body = resp.read(max_bytes + 1)
        if len(body) > max_bytes:
            raise ValueError(
                f"HTTP price fetch for {symbol!r} from {url} exceeded the "
                f"{max_bytes}-byte response cap")
        text = body.decode("utf-8", errors="replace")
        series = parse_price_lines(symbol, text.splitlines())
        if series.prices.size == 0:
            # A 200 whose body parses to nothing (error page, captive
            # portal, truncated response) must fail LOUDLY: caching or
            # journaling an empty series would poison every later request
            # for the symbol, surviving restarts via replay.
            raise ValueError(
                f"HTTP price fetch for {symbol!r} from {url} returned no "
                f"parsable 'price, date' rows ({len(text)} bytes)")
        return series
    return fetch


class FileTailFeed:
    """Incremental reader of an append-only ``price, date`` feed — the
    streaming-ingest half of the replay data plane: a producer (live
    market tap, the synthetic generator, another process) APPENDS rows to
    a file or FIFO it owns, and each :meth:`poll` consumes exactly the
    complete rows added since the previous poll. The consumer never owns
    or rewrites the feed — the decoupled-dataflow seam actor/learner
    disaggregation cuts at (MindSpeed RL's decoupled design,
    arxiv 2507.19017).

    Durability/parse contract matches the batch CSV loader
    (data/ingest.py ``parse_price_lines``: malformed rows dropped,
    date-sorted), so consuming a feed incrementally converges to exactly
    the series a one-shot ``load_price_csv`` of the final file returns —
    the parity the tests pin. A trailing partial line (a producer caught
    mid-append) is held back until its newline arrives; a FIFO is read
    non-blocking so a quiet producer yields an empty delta, never a hang."""

    def __init__(self, path: str):
        self.path = path
        self._offset = 0
        self._partial = b""
        #: FIFO read end, opened once and HELD across polls: closing it
        #: between polls would leave the pipe reader-less, and the
        #: producer's next write would raise SIGPIPE/BrokenPipeError (or
        #: its O_NONBLOCK open would fail ENXIO) — a persistent producer
        #: must survive an idle consumer.
        self._fifo_fd: int | None = None

    def close(self) -> None:
        if self._fifo_fd is not None:
            os.close(self._fifo_fd)
            self._fifo_fd = None

    def _read_new_bytes(self) -> bytes:
        try:
            st = os.stat(self.path)
        except FileNotFoundError:
            return b""
        import stat as stat_mod
        if stat_mod.S_ISFIFO(st.st_mode):
            # FIFO: non-blocking drain of whatever the producer has
            # written; EAGAIN / no-writer-yet reads as an empty delta.
            if self._fifo_fd is None:
                try:
                    self._fifo_fd = os.open(
                        self.path, os.O_RDONLY | os.O_NONBLOCK)
                except OSError:
                    return b""
            chunks = []
            while True:
                try:
                    chunk = os.read(self._fifo_fd, 1 << 16)
                except BlockingIOError:
                    break
                if not chunk:
                    break
                chunks.append(chunk)
            return b"".join(chunks)
        if st.st_size <= self._offset:
            return b""
        with open(self.path, "rb") as f:
            f.seek(self._offset)
            data = f.read()
        self._offset += len(data)
        return data

    def poll(self, symbol: str) -> PriceSeries:
        """Parse the rows appended since the last poll (possibly none)."""
        from sharetrade_tpu_torch.data.ingest import parse_price_lines
        data = self._partial + self._read_new_bytes()
        head, sep, tail = data.rpartition(b"\n")
        if not sep:
            # No complete line yet: everything stays buffered.
            self._partial = data
            return parse_price_lines(symbol, [])
        self._partial = tail
        return parse_price_lines(
            symbol, head.decode("utf-8", errors="replace").splitlines())


def append_feed_rows(path: str, series: PriceSeries) -> None:
    """Producer-side helper: append a series as ``price, date`` rows to a
    feed file (the synthetic generator behind the file/FIFO provider).
    Append-only by contract — the consumer tracks byte offsets.

    Concurrent-writer guard (same contract as the framed journal's): the
    flock'd ``.lock`` is held for the duration of the append and
    raises :class:`~sharetrade_tpu_torch.data.journal.JournalLockError` when
    another LIVE process is mid-append on the same feed — two producers
    interleaving partial lines would corrupt rows in a way the parser can
    only drop, not detect. A dead writer's flock dies with it. FIFOs
    are exempt: the kernel serializes sub-PIPE_BUF writes there, and a
    lockfile next to a FIFO consumer would outlive the pipe's semantics."""
    import stat as stat_mod

    from sharetrade_tpu_torch.data.journal import (
        acquire_writer_lock, release_writer_lock)
    try:
        is_fifo = stat_mod.S_ISFIFO(os.stat(path).st_mode)
    except FileNotFoundError:
        is_fifo = False
    if not is_fifo:
        acquire_writer_lock(path)
    try:
        with open(path, "a", encoding="utf-8") as f:
            for d, p in zip(series.dates, series.prices):
                f.write(f"{float(p)}, {d}\n")
    finally:
        if not is_fifo:
            release_writer_lock(path)


def synthetic_provider(length: int = 6046, seed: int = 1992) -> Callable[..., PriceSeries]:
    def fetch(symbol: str, start=None, end=None) -> PriceSeries:
        # Per-symbol seed derivation: distinct symbols get distinct (but
        # reproducible) walks, so multi-asset portfolios see real dispersion.
        sym_seed = seed + (zlib.crc32(symbol.encode()) % 65536)
        return synthetic_price_series(symbol=symbol, length=length, seed=sym_seed)
    return fetch


class PriceDataService:
    def __init__(
        self,
        journal: Journal | None = None,
        provider: PriceProvider | None = None,
        config: DataConfig | None = None,
    ):
        cfg = config or DataConfig()
        if provider is None:
            if cfg.http_url:
                provider = http_provider(cfg.http_url)
            elif cfg.csv_path:
                provider = csv_provider(cfg.csv_path)
            else:
                provider = synthetic_provider(cfg.synthetic_length, cfg.synthetic_seed)
        self._provider = provider
        if journal is None:
            journal = _open_journal(
                os.path.join(cfg.journal_dir, "price-events.journal"))
        self._journal = journal
        self._cache: dict[str, PriceSeries] = {}
        # Auto-compaction (reference application.conf:7-14 compaction
        # intervals): every N appended fetch events the log collapses to
        # one snapshot per symbol, so a long-lived service's journal stays
        # bounded without anyone remembering to call compact().
        self._compact_every = cfg.price_compact_every_events
        self._journal_events = 0
        # Streaming ingest (tail): per-symbol incremental feed readers,
        # lazily attached from data.feed_path ("{symbol}" substituted) or
        # explicitly via attach_feed.
        self._feed_path = cfg.feed_path
        self._feeds: dict[str, FileTailFeed] = {}
        self._recover()

    # ---- public protocol (the RequestStockPrice equivalent) ----

    def request(
        self,
        symbol: str,
        start: date | str | None = None,
        end: date | str | None = None,
    ) -> StockDataResponse:
        if symbol not in self._cache:
            # Fetch the FULL history on a miss and filter only the reply:
            # caching a range-limited fetch would poison later unranged
            # requests (and the journal) with partial data.
            fetched = self._provider(symbol, None, None)
            self._persist(symbol, fetched)
            self._merge(symbol, fetched)
            self._maybe_compact()
        else:
            log.debug("cache hit for %s", symbol)
        return StockDataResponse(symbol, self._cache[symbol].range(start, end))

    def refresh(self, symbol: str) -> StockDataResponse:
        """Force a new fetch and merge (old values win collisions)."""
        fetched = self._provider(symbol, None, None)
        self._persist(symbol, fetched)
        self._merge(symbol, fetched)
        self._maybe_compact()
        return StockDataResponse(symbol, self._cache[symbol])

    def attach_feed(self, symbol: str, feed: FileTailFeed) -> None:
        """Wire an append-only feed for ``symbol`` (tests / embedders that
        don't route through ``data.feed_path``)."""
        self._feeds[symbol] = feed

    def tail(self, symbol: str) -> StockDataResponse:
        """Streaming ingest: consume the rows APPENDED to the symbol's
        feed since the last tail() call, merge them into the cache, and
        persist the delta as a journal event (the same ``prices_fetched``
        event recovery already replays). Returns the DELTA series —
        only dates genuinely NEW to the cache, so a restarted consumer
        (whose in-memory feed offset reset to zero) re-scans the file's
        bytes but re-ingests nothing: rows the journal already recovered
        filter out, and only rows appended while the process was down
        come back as delta. Possibly empty — a quiet feed is not an
        error; read the full merged history with ``request``. The feed
        is append-only and producer-owned: the learner trains from a
        stream it doesn't own, which is the seam actor/learner
        disaggregation cuts at."""
        feed = self._feeds.get(symbol)
        if feed is None:
            if not self._feed_path:
                raise ValueError(
                    f"no feed attached for {symbol!r}: set data.feed_path "
                    "or call attach_feed()")
            feed = FileTailFeed(self._feed_path.replace("{symbol}", symbol))
            self._feeds[symbol] = feed
        delta = feed.poll(symbol)
        cached = self._cache.get(symbol)
        if len(delta) and cached is not None and len(cached):
            # Restart dedupe: drop rows the (journal-recovered) cache
            # already holds — without this, the first poll after a
            # restart would return AND re-journal the whole history as
            # one giant "delta".
            import numpy as np
            fresh = ~np.isin(delta.dates, cached.dates)
            if not fresh.all():
                delta = PriceSeries(symbol, delta.dates[fresh],
                                    delta.prices[fresh])
        if len(delta):
            self._persist(symbol, delta)
            self._merge(symbol, delta)
            self._maybe_compact()
        return StockDataResponse(symbol, delta)

    def cached_symbols(self) -> list[str]:
        return sorted(self._cache)

    def compact(self) -> None:
        """Collapse the event log to one snapshot event per symbol — the
        LevelDB-compaction capability of the reference's journal config
        (application.conf:7-14), done explicitly: recovery replays the same
        cache from far fewer events."""
        events = [{"type": "prices_fetched", "symbol": s,
                   "series": self._cache[s].to_dict()}
                  for s in self.cached_symbols()]
        self._journal.compact(events)
        self._journal_events = len(events)

    def close(self) -> None:
        for feed in self._feeds.values():
            close_feed = getattr(feed, "close", None)
            if close_feed is not None:
                close_feed()
        self._journal.close()

    # ---- event sourcing ----

    def _persist(self, symbol: str, series: PriceSeries) -> None:
        self._journal.append({"type": "prices_fetched", "symbol": symbol,
                              "series": series.to_dict()})
        self._journal_events += 1

    def _maybe_compact(self) -> None:
        """Threshold check, called AFTER the fetch is merged into the
        cache: compact() snapshots the cache, so compacting from inside
        _persist (pre-merge) would rewrite the journal without the very
        event that crossed the threshold — losing it across restarts.

        The trigger measures REDUNDANCY (journal events beyond the one
        snapshot per symbol a compaction would leave), not raw journal
        size: a service caching more symbols than the threshold would
        otherwise sit above it permanently and rewrite the whole journal
        on every fetch."""
        if (self._compact_every > 0
                and (self._journal_events - len(self._cache)
                     > self._compact_every)):
            log.info("auto-compacting price journal: %d events for %d "
                     "symbols", self._journal_events, len(self._cache))
            self.compact()

    def _merge(self, symbol: str, fetched: PriceSeries) -> None:
        if symbol in self._cache:
            self._cache[symbol] = self._cache[symbol].merge_keep_old(fetched)
        else:
            self._cache[symbol] = fetched

    def _recover(self) -> None:
        count = 0
        for event in self._journal.replay():
            if event.get("type") == "prices_fetched":
                series = PriceSeries.from_dict(event["series"])
                self._merge(event["symbol"], series)
                count += 1
        # The counter tracks events currently IN the journal (replay sees
        # them all), so a journal bloated by a previous un-compacted run
        # crosses the threshold on the first fetch after restart.
        self._journal_events = count
        if count:
            log.info("recovered %d fetch events for %s", count, self.cached_symbols())


def _open_journal(path: str, *, fsync_every_records: int = 1,
                  fsync_interval_s: float = 0.0,
                  segment_records: int = 0) -> Journal:
    """Open an event journal: the one place that picks its backend. The
    JAX package takes its C++ backend here when that is built
    (``data.use_native_journal``, and for the transitions journal
    ``data.async_transition_writer``); the port has only the pure-Python
    journal, which writes the same format, so those knobs select nothing.
    The group-commit watermarks (``data.journal_fsync_*``) and segment
    rotation (``segment_records``, 0 = one file) pass through."""
    return Journal(path, fsync_every_records=fsync_every_records,
                   fsync_interval_s=fsync_interval_s,
                   segment_records=segment_records)
