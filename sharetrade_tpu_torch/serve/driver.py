"""Synthetic portfolio-session load for the serving engine.

Counterpart of the JAX package's ``serve/driver.py`` (closed loop only). One
:class:`SessionSim` is one "user": a cursor into a price series plus a
host-side portfolio that follows the served actions, with the trade rules of
the trading environment (over an (A, T) matrix, those of the portfolio
environment, ``env/portfolio.py``). Sessions start at staggered offsets, so
a batch mixes episode clocks and portfolios.

:func:`run_closed_loop` keeps ``concurrency`` sessions with exactly one
request in flight each (submit on completion) for ``duration_s`` and
reports achieved QPS and latency percentiles. It drives anything with the
``submit(session_id, obs, callback=) -> handle`` surface. The open-loop
harness and the batch-1 baseline server are not yet ported.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any

import numpy as np

from sharetrade_tpu_torch.serve.engine import latency_percentiles


class SessionSim:
    """One synthetic user session over a price series (T,), or over an
    (A, T) matrix of A assets: the observation is then the A windows side
    by side, the budget and the A share counts, and action ``a`` buys one
    share of asset ``a`` (a < A), sells one of asset ``a - A`` (a < 2A) or
    holds, each trade by the single-asset rules. The budget is kept in
    float32, as the env keeps it, so the session's observations are the
    env's to the bit. At A = 1 both forms are the same session."""

    def __init__(self, session_id: Any, prices: np.ndarray, window: int,
                 start: int, *, budget: float = 2400.0, shares: float = 0.0):
        self.session_id = session_id
        self.prices = prices
        grid = np.asarray(prices, np.float32)
        self._grid = grid if grid.ndim == 2 else grid[None, :]
        self.window = window
        self.start = int(start)
        self.t = 0
        self._budget0, self._shares0 = np.float32(budget), float(shares)
        self.budget = self._budget0
        self.shares = np.full(len(self._grid), self._shares0)
        self.generation = 0         # bumps on wrap → fresh session id

    @property
    def sid(self) -> Any:
        """The WIRE session id: wraps restart the episode under a new id
        (user churn — naturally exercises eviction + cold re-admission)."""
        return (self.session_id if self.generation == 0
                else f"{self.session_id}#{self.generation}")

    def observation(self) -> np.ndarray:
        lo = self.start + self.t
        return np.concatenate(
            [self._grid[:, lo:lo + self.window].ravel(),
             [self.budget], self.shares]
        ).astype(np.float32)

    def advance(self, action: int) -> None:
        """Apply the served action with the env's trade rules, move one
        tick; restart (new generation, fresh portfolio) at series end."""
        assets = len(self._grid)
        price = self._grid[:, self.start + self.t + self.window]
        if action < assets and self.budget >= price[action]:
            self.budget -= price[action]
            self.shares[action] += 1.0
        elif assets <= action < 2 * assets and self.shares[action - assets]:
            self.budget += price[action - assets]
            self.shares[action - assets] -= 1.0
        self.t += 1
        if self.start + self.t + self.window >= self._grid.shape[1]:
            self.t = 0
            self.budget = self._budget0
            self.shares[:] = self._shares0
            self.generation += 1


def make_sessions(prices: Any, window: int, n: int, *,
                  seed: int = 0, prefix: str = "s") -> list[SessionSim]:
    """``n`` sessions with staggered starts across the series (T,) or the
    (A, T) matrix. ``prefix`` namespaces the session ids — measurement
    phases that share one engine must not reuse ids, or a "fresh" session
    would silently hit its predecessor's still-warm slot carry instead of
    prefilling."""
    prices = np.asarray(prices, np.float32)
    horizon = prices.shape[-1] - window - 1
    if horizon < 1:
        raise ValueError(f"price series too short for window={window}")
    rng = np.random.default_rng(seed)
    starts = rng.integers(0, max(horizon - 1, 1), size=n)
    return [SessionSim(f"{prefix}{i}", prices, window, starts[i])
            for i in range(n)]


_percentiles = latency_percentiles   # one quantile convention, serve-wide


def run_closed_loop(server: Any, sessions: list[SessionSim], *,
                    concurrency: int, duration_s: float,
                    stop: threading.Event | None = None) -> dict:
    """``concurrency`` sessions each keep one request in flight for
    ``duration_s``; returns achieved QPS + latency percentiles (plus a
    ``failed`` count — requests that terminated without a result: batch
    failures, sheds, deadline expiries)."""
    lock = threading.Lock()
    lat: list[float] = []
    done_evt = threading.Event()
    state = {"inflight": 0, "failed": 0}
    #: Sessions whose request FAILED, parked for the main thread to
    #: resubmit. An overload-shedding engine completes a rejected submit
    #: synchronously on the submitting thread — resubmitting from inside
    #: the callback would recurse submit→reject→callback→submit without
    #: bound under sustained overload, so the failure path always defers.
    retry: deque[SessionSim] = deque()  # at most one entry per session
    t_end = time.perf_counter() + duration_s

    def cb_for(sess: SessionSim):
        def cb(result, _sess=sess):
            if result is not None:
                with lock:
                    lat.append(result.latency_ms)
                _sess.advance(result.action)
                now = time.perf_counter()
                if now < t_end and not (stop is not None
                                        and stop.is_set()):
                    try:
                        server.submit(_sess.sid, _sess.observation(), cb)
                        return
                    except Exception:   # noqa: BLE001 — engine stopped
                        # or terminally failed between the completion and
                        # this resubmit: retire the session below instead
                        # of letting the engine's callback guard swallow
                        # the raise and strand done_evt.
                        pass
            else:
                with lock:
                    state["failed"] += 1
                now = time.perf_counter()
                if now < t_end and not (stop is not None
                                        and stop.is_set()):
                    with lock:
                        retry.append(_sess)
                    return
            with lock:
                state["inflight"] -= 1
                if state["inflight"] == 0:
                    done_evt.set()
        return cb

    t0 = time.perf_counter()
    with lock:
        state["inflight"] = min(concurrency, len(sessions))
    for sess in sessions[:concurrency]:
        server.submit(sess.sid, sess.observation(), cb_for(sess))
    deadline = time.monotonic() + duration_s + 30.0
    while not done_evt.is_set() and time.monotonic() < deadline:
        with lock:
            parked = list(retry)
            retry.clear()
        if parked:
            now = time.perf_counter()
            for sess in parked:
                resubmitted = False
                if now < t_end and not (stop is not None
                                        and stop.is_set()):
                    try:
                        server.submit(sess.sid, sess.observation(),
                                      cb_for(sess))
                        resubmitted = True
                    except Exception:   # noqa: BLE001 — engine gone
                        # terminal mid-harness: retire the session, keep
                        # the measurement loop accountable.
                        pass
                if not resubmitted:
                    with lock:
                        state["inflight"] -= 1
                        if state["inflight"] == 0:
                            done_evt.set()
        done_evt.wait(0.01)
    elapsed = time.perf_counter() - t0
    with lock:
        n = len(lat)
        failed = state["failed"]
    return {"mode": "closed_loop", "concurrency": concurrency,
            "completed": n, "failed": failed, "elapsed_s": elapsed,
            "qps": n / max(elapsed, 1e-9), **_percentiles(lat)}
