"""The port's price data service (``sharetrade_tpu_torch/data/service.py``)
against the JAX package's, on the CPU.

- One fetch / refresh / compact sequence (CSV provider, two symbols, a
  refresh whose file changed in between, old values winning the merge)
  gives byte-identical price journals in both packages, and each package
  recovers the other's cache from its journal without fetching.
- Auto-compaction on redundancy (``data.price_compact_every_events``):
  the same events and the same compaction point in both, and a journal
  bloated by an earlier run compacts on the first fetch after a restart.
- The HTTP provider against a server on 127.0.0.1 (no network): the same
  series as the JAX provider, the URL-quoted symbol, the service over
  ``data.http_url`` journaling what it fetched; a non-http scheme and a
  body that parses to nothing are refused as in the JAX package.
- Streaming feeds: ``FileTailFeed`` on a file (a partial line held back
  until its newline) and on a FIFO gives the JAX feed's deltas; ``tail``
  through ``data.feed_path`` journals only new rows, and after a restart
  re-ingests nothing the journal recovered (the restart dedupe).
- ``cli query`` prints the JAX ``cli query``'s JSON line.

Every journal sits under ``tmp_path``; each test closes one package's
service before the other opens the same journal.
"""

import http.server
import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest

from sharetrade_tpu.config import DataConfig as JaxDataConfig
from sharetrade_tpu.data import service as jservice
from sharetrade_tpu_torch.config import DataConfig
from sharetrade_tpu_torch.data import service as tservice

PACKAGES = {"jax": (jservice, JaxDataConfig),
            "torch": (tservice, DataConfig)}
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _csv(path, rows):
    with open(path, "w") as f:
        for price, date in rows:
            f.write(f"{price}, {date}\n")


def _service(name, journal_dir, **data):
    mod, cfg_cls = PACKAGES[name]
    return mod.PriceDataService(config=cfg_cls(journal_dir=str(journal_dir),
                                               **data))


def _refuse(symbol, start=None, end=None):
    raise AssertionError(f"recovery must not fetch {symbol}")


def _journal_bytes(journal_dir):
    return (journal_dir / "price-events.journal").read_bytes()


def _run_sequence(name, tmp_path):
    csv = tmp_path / f"{name}.csv"
    _csv(csv, [(56.08, "1992-07-22"), (55.65, "1992-07-23"),
               (57.0123456789, "1992-07-24")])
    journal_dir = tmp_path / f"{name}-journal"
    svc = _service(name, journal_dir, csv_path=str(csv),
                   price_compact_every_events=0)
    replies = [svc.request("MSFT", "1992-07-23", None),
               svc.request("AAPL"), svc.request("MSFT")]
    _csv(csv, [(99.0, "1992-07-22"), (58.5, "1992-07-27")])
    replies.append(svc.refresh("MSFT"))
    svc.compact()
    replies.append(svc.request("MSFT"))
    svc.close()
    return journal_dir, replies


def _same_series(a, b):
    np.testing.assert_array_equal(a.dates, b.dates)
    np.testing.assert_array_equal(a.prices, b.prices)


def test_same_sequence_same_journal_and_cross_recovery(tmp_path):
    dirs, replies = {}, {}
    for name in PACKAGES:
        dirs[name], replies[name] = _run_sequence(name, tmp_path)
    assert _journal_bytes(dirs["jax"]) == _journal_bytes(dirs["torch"])
    for a, b in zip(replies["jax"], replies["torch"]):
        assert a.symbol == b.symbol
        _same_series(a.series, b.series)
    # Old values win: 1992-07-22 keeps 56.08, the new date merges in.
    merged = replies["torch"][-1].series
    assert merged.prices[0] == np.float32(56.08) and len(merged) == 4
    for reader, writer in (("torch", "jax"), ("jax", "torch")):
        mod, cfg_cls = PACKAGES[reader]
        svc = mod.PriceDataService(provider=_refuse, config=cfg_cls(
            journal_dir=str(dirs[writer])))
        assert svc.cached_symbols() == ["AAPL", "MSFT"]
        _same_series(svc.request("MSFT").series, merged)
        svc.close()


def test_auto_compaction_matches_and_runs_after_restart(tmp_path):
    dirs = {}
    for name in PACKAGES:
        journal_dir = tmp_path / name
        svc = _service(name, journal_dir, synthetic_length=40,
                       price_compact_every_events=0)
        svc.request("MSFT")
        for _ in range(5):                    # a bloated, uncompacted log
            svc.refresh("MSFT")
        svc.close()
        svc = _service(name, journal_dir, synthetic_length=40,
                       price_compact_every_events=3)
        assert svc._journal_events == 6       # every event replayed
        svc.request("AAPL")                   # crosses the redundancy bar
        assert svc._journal_events == 2       # one snapshot per symbol
        svc.refresh("AAPL")
        svc.close()
        dirs[name] = journal_dir
    assert _journal_bytes(dirs["jax"]) == _journal_bytes(dirs["torch"])
    from sharetrade_tpu_torch.data.journal import Journal
    with Journal(str(dirs["torch"] / "price-events.journal")) as j:
        assert [e["symbol"] for e in j.replay()] == ["AAPL", "MSFT", "AAPL"]


# ---------------------------------------------------------------------------
# the HTTP provider
# ---------------------------------------------------------------------------

@pytest.fixture
def price_server():
    body = (b"56.08, 1992-07-22\n55.65, 1992-07-23\nbad row\n"
            b"57.01, 1992-07-24\n")
    requested = []

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            requested.append(self.path)
            if self.path.startswith("/prices/"):
                self.send_response(200)
                self.send_header("Content-Type", "text/csv")
                self.end_headers()
                self.wfile.write(body)
            elif self.path.startswith("/empty/"):
                self.send_response(200)
                self.end_headers()
                self.wfile.write(b"<html>maintenance</html>\n")
            else:
                self.send_error(404)

        def log_message(self, *args):
            pass

    server = http.server.HTTPServer(("127.0.0.1", 0), Handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        yield f"http://127.0.0.1:{server.server_port}", requested
    finally:
        server.shutdown()
        thread.join()


def test_http_provider_matches_the_reference(price_server, tmp_path):
    base, requested = price_server
    template = base + "/prices/{symbol}.csv"
    got = tservice.http_provider(template)("BRK B")
    want = jservice.http_provider(template)("BRK B")
    _same_series(got, want)
    assert len(got) == 3 and got.symbol == "BRK B"
    assert requested == ["/prices/BRK%20B.csv"] * 2
    # The service over data.http_url journals the fetch; a restart
    # recovers it without asking the server again.
    svc = _service("torch", tmp_path / "j", http_url=template)
    _same_series(svc.request("MSFT").series, want)
    svc.close()
    svc = _service("torch", tmp_path / "j", http_url=base + "/gone/{symbol}")
    assert svc.cached_symbols() == ["MSFT"]
    assert len(svc.request("MSFT").series) == 3
    svc.close()
    assert len(requested) == 3


def test_http_provider_refusals(price_server, tmp_path):
    base, _ = price_server
    for mod in (tservice, jservice):
        with pytest.raises(ValueError, match="http"):
            mod.http_provider(f"file://{tmp_path}/prices.csv")
        with pytest.raises(ValueError, match="no parsable"):
            mod.http_provider(base + "/empty/{symbol}")("MSFT")
    from urllib.error import HTTPError
    with pytest.raises(HTTPError):
        tservice.http_provider(base + "/missing/{symbol}")("MSFT")


# ---------------------------------------------------------------------------
# streaming feeds
# ---------------------------------------------------------------------------

def _polls(mod, path, writes):
    """Each write appended to the feed, then one poll; the deltas."""
    feed = mod.FileTailFeed(str(path))
    out = []
    try:
        for chunk in writes:
            if chunk:
                fd = os.open(str(path), os.O_WRONLY | os.O_APPEND)
                os.write(fd, chunk)
                os.close(fd)
            out.append(feed.poll("MSFT"))
    finally:
        feed.close()
    return out


WRITES = [b"56.08, 1992-07-22\n55.6", b"5, 1992-07-23\n", b"",
          b"bad\n57.01, 1992-07-24\n"]


def test_file_tail_feed_matches_the_reference(tmp_path):
    deltas = {}
    for name, (mod, _) in PACKAGES.items():
        path = tmp_path / f"{name}.feed"
        path.write_bytes(b"")
        deltas[name] = _polls(mod, path, WRITES)
    assert [len(d) for d in deltas["torch"]] == [1, 1, 0, 1]
    for a, b in zip(deltas["jax"], deltas["torch"]):
        _same_series(a, b)


def test_fifo_feed_reads_without_blocking(tmp_path):
    path = tmp_path / "prices.fifo"
    os.mkfifo(path)
    feed = tservice.FileTailFeed(str(path))
    try:
        assert len(feed.poll("MSFT")) == 0      # no writer yet: empty
        writer = os.open(str(path), os.O_WRONLY | os.O_NONBLOCK)
        os.write(writer, b"56.08, 1992-07-22\n55.65, 19")
        first = feed.poll("MSFT")
        assert len(feed.poll("MSFT")) == 0      # a quiet producer
        os.write(writer, b"92-07-23\n")
        second = feed.poll("MSFT")
        os.close(writer)
    finally:
        feed.close()
    assert [str(d) for d in first.dates] == ["1992-07-22"]
    assert [str(d) for d in second.dates] == ["1992-07-23"]


def test_tail_journals_deltas_and_dedupes_after_a_restart(tmp_path):
    feeds = tmp_path / "feeds"
    feeds.mkdir()
    journals = {}
    for name, (mod, _) in PACKAGES.items():
        feed_path = feeds / f"{name}-MSFT.csv"
        kw = {"feed_path": str(feeds / (name + "-{symbol}.csv")),
              "price_compact_every_events": 0}
        _csv(feed_path, [(56.08, "1992-07-22"), (55.65, "1992-07-23")])
        svc = _service(name, tmp_path / f"{name}-journal", **kw)
        assert len(svc.tail("MSFT").series) == 2
        assert len(svc.tail("MSFT").series) == 0     # nothing new
        svc.close()
        with open(feed_path, "a") as f:
            f.write("57.01, 1992-07-24\n")
        svc = _service(name, tmp_path / f"{name}-journal", **kw)
        delta = svc.tail("MSFT").series      # the file re-read from byte 0
        assert [str(d) for d in delta.dates] == ["1992-07-24"]
        assert len(svc.request("MSFT").series) == 3
        svc.close()
        journals[name] = tmp_path / f"{name}-journal"
    assert (_journal_bytes(journals["jax"])
            == _journal_bytes(journals["torch"]))
    with pytest.raises(ValueError, match="feed"):
        _service("torch", tmp_path / "nofeed").tail("MSFT")


# ---------------------------------------------------------------------------
# cli query
# ---------------------------------------------------------------------------

def test_cli_query_prints_the_reference_line(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""), JAX_PLATFORMS="cpu")
    lines = {}
    for name, pkg in (("jax", "sharetrade_tpu"),
                      ("torch", "sharetrade_tpu_torch")):
        cwd = tmp_path / name
        cwd.mkdir()
        out = subprocess.run(
            [sys.executable, "-m", f"{pkg}.cli", "query", "--symbol", "MSFT",
             "--start", "1992-07-22", "--end", "1993-01-01",
             "--set", "data.synthetic_length=400"],
            capture_output=True, text=True, timeout=120, cwd=cwd, env=env)
        assert out.returncode == 0, out.stderr[-2000:]
        lines[name] = out.stdout.strip().splitlines()[-1]
    assert lines["torch"] == lines["jax"]
    assert json.loads(lines["torch"])["rows"] > 0
    # The query journaled its fetch in the reference's format.
    assert (_journal_bytes(tmp_path / "torch" / "journal")
            == _journal_bytes(tmp_path / "jax" / "journal"))
