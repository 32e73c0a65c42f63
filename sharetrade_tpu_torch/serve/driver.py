"""Synthetic portfolio-session load for the serving engine.

Counterpart of the JAX package's ``serve/driver.py``. One
:class:`SessionSim` is one "user": a cursor into a price series plus a
host-side portfolio that follows the served actions, with the trade rules of
the trading environment (over an (A, T) matrix, those of the portfolio
environment, ``env/portfolio.py``). Sessions start at staggered offsets, so
a batch mixes episode clocks and portfolios.

Two harnesses, for anything with the ``submit(session_id, obs, callback=)
-> handle`` surface:

- :func:`run_closed_loop` keeps ``concurrency`` sessions with exactly one
  request in flight each (submit on completion) for ``duration_s``;
  ``concurrency=1`` against :class:`BatchOneServer` is the batch-1
  baseline: one model call and one blocking readback per request.
- :func:`run_open_loop` offers arrivals at a fixed rate whatever the
  completions; an arrival that finds every session busy counts as
  ``dropped``.

Both report achieved QPS and latency percentiles.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict, deque
from typing import Any, Callable

import numpy as np
import torch

from sharetrade_tpu_torch.models.core import tree_map
from sharetrade_tpu_torch.precision import FP32
from sharetrade_tpu_torch.serve.engine import ServeResult, latency_percentiles


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


class BatchOneServer:
    """The per-request baseline: the engine's ``submit`` surface, but every
    request is one B = 1 model call with a blocking readback, on one
    worker thread, with each session's carry threaded on the device (a
    fresh session through ``apply_prefill``, a returning one through
    ``apply_serve_batch``; a model without that pair through
    ``apply_batch`` from the init carry) — the JAX package's ``model.apply``
    per request."""

    #: Bound on retained per-session carries (wrapped sessions mint new
    #: ids); the least recently used is dropped first.
    MAX_CARRIES = 4096

    def __init__(self, model: Any, params: Any, *, precision=None):
        precision = precision or FP32
        self.model = model
        self.device = model.device
        with torch.inference_mode():
            self._params = precision.cast_compute(params)
            self._carry0 = tree_map(
                lambda x: x.to(self.device)[None],
                precision.cast_carry(model.init_carry(), model))
        self._pair = (model.apply_prefill is not None
                      and model.apply_serve_batch is not None)
        self._carries: OrderedDict[Any, Any] = OrderedDict()
        self._q: deque[tuple] = deque()
        self._cv = threading.Condition()
        self._stopped = False
        self._thread = threading.Thread(target=self._loop,
                                        name="b1-server", daemon=True)
        self._thread.start()

    def _apply(self, obs: np.ndarray, carry: Any):
        x = torch.from_numpy(obs[None]).to(self.device)
        if not self._pair:
            return self.model.apply_batch(
                self._params, x, self._carry0 if carry is None else carry)
        if carry is None:
            return self.model.apply_prefill(self._params, x)
        return self.model.apply_serve_batch(self._params, x, carry)

    def warmup(self) -> None:
        obs = np.full((self.model.obs_dim,), 10.0, np.float32)
        with torch.inference_mode():
            out, carry = self._apply(obs, None)
            out, _ = self._apply(obs, carry)
            out.logits.cpu()

    def submit(self, session_id: Any, obs: Any,
               callback: Callable | None = None):
        event = threading.Event()
        slot: list = [None]
        with self._cv:
            self._q.append((session_id, np.asarray(obs, np.float32),
                            callback, event, slot, time.perf_counter()))
            self._cv.notify()

        class _Handle:              # the engine handle's wait()
            def wait(_self, timeout=None):
                event.wait(timeout)
                return slot[0]
        return _Handle()

    def drain(self, timeout_s: float = 30.0) -> bool:
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            with self._cv:
                if not self._q:
                    return True
            time.sleep(0.002)
        return False

    def stop(self, **_kw) -> bool:
        with self._cv:
            self._stopped = True
            self._cv.notify()
        self._thread.join(10.0)
        return not self._thread.is_alive()

    def _loop(self) -> None:
        while True:
            with self._cv:
                while not self._q and not self._stopped:
                    self._cv.wait(0.05)
                if self._stopped and not self._q:
                    return
                sid, obs, callback, event, slot, t_enq = self._q.popleft()
            carry = self._carries.get(sid)
            if carry is not None:
                self._carries.move_to_end(sid)
            try:
                with torch.inference_mode():
                    out, carry = self._apply(obs, carry)
                    logits = out.logits[0].cpu().numpy()  # the per-request sync
                    value = float(out.value[0])
            except Exception:   # noqa: BLE001 — fail the request, keep going
                self._carries.pop(sid, None)
                event.set()
                if callback is not None:
                    callback(None)
                continue
            self._carries[sid] = carry
            if len(self._carries) > self.MAX_CARRIES:
                self._carries.popitem(last=False)
            result = ServeResult(
                session_id=sid, action=int(np.argmax(logits)),
                logits=logits, value=value, params_step=0,
                latency_ms=(time.perf_counter() - t_enq) * 1e3)
            slot[0] = result
            event.set()
            if callback is not None:
                callback(result)


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


def run_open_loop(server: Any, sessions: list[SessionSim], *,
                  rate_qps: float, duration_s: float,
                  stop: threading.Event | None = None) -> dict:
    """Arrivals at ``rate_qps`` for ``duration_s``: each takes the next
    session with no request in flight (round-robin); an arrival that finds
    every session busy counts as ``dropped``. Returns offered, dropped,
    completed and failed counts, achieved QPS and latency percentiles."""
    lock = threading.Lock()
    lat: list[float] = []
    ready: deque[SessionSim] = deque(sessions)
    offered = dropped = 0
    inflight = {"n": 0, "failed": 0, "last_done": time.perf_counter()}
    idle_evt = threading.Event()

    def cb_for(sess: SessionSim):
        def cb(result, _sess=sess):
            with lock:
                if result is not None:
                    lat.append(result.latency_ms)
                    inflight["last_done"] = time.perf_counter()
                else:
                    inflight["failed"] += 1
                inflight["n"] -= 1
                if inflight["n"] == 0:
                    idle_evt.set()
            if result is not None:
                _sess.advance(result.action)
            with lock:
                ready.append(_sess)      # failed or not, back in rotation
        return cb

    spacing = 1.0 / max(rate_qps, 1e-9)
    t0 = time.perf_counter()
    t_end = gen_end = t0 + duration_s
    issued = 0
    while True:
        now = time.perf_counter()
        if now >= t_end or (stop is not None and stop.is_set()):
            gen_end = now
            break
        # Issue every arrival due by the wall clock at once, so sleep
        # jitter shifts arrivals but never lowers the offered rate.
        due = int((now - t0) / spacing) + 1 - issued
        if due <= 0:
            time.sleep(min(t0 + issued * spacing - now, 0.001))
            continue
        for _ in range(min(due, 512)):
            issued += 1
            offered += 1
            with lock:
                sess = ready.popleft() if ready else None
            if sess is None:
                dropped += 1
                continue
            with lock:
                inflight["n"] += 1
                idle_evt.clear()
            try:
                server.submit(sess.sid, sess.observation(), cb_for(sess))
            except Exception:   # noqa: BLE001 — engine stopped or failed
                with lock:
                    inflight["failed"] += 1
                    inflight["n"] -= 1
                    if inflight["n"] == 0:
                        idle_evt.set()
                    ready.append(sess)
    # The tail of in-flight requests completes before measuring; QPS is over
    # [start, max(last completion, the generation span)].
    with lock:
        if inflight["n"] == 0:
            idle_evt.set()
    idle_evt.wait(10.0)
    with lock:
        n = len(lat)
        failed = inflight["failed"]
        elapsed = max(inflight["last_done"] - t0,
                      min(duration_s, gen_end - t0))
    return {"mode": "open_loop", "rate_qps": rate_qps,
            "offered": offered, "dropped": dropped, "completed": n,
            "failed": failed, "elapsed_s": elapsed,
            "qps": n / max(elapsed, 1e-9), **_percentiles(lat)}
