"""Continuous-batching inference engine over a session slot arena.

Counterpart of the JAX package's ``serve/engine.py``: per-user
``(window, portfolio)`` queries are coalesced into padded device batches
under a deadline (``serve.max_batch`` / ``serve.batch_timeout_ms``), and each
session's recurrent carry (the episode transformer's K/V ring) lives in a
device-resident ARENA of ``slots + max_batch`` rows — one row per slot plus
``max_batch`` scratch rows that padding rows read and write, so a partial
batch never touches a live session.

Structure (the JAX engine's dispatcher/consumer split):

- **submit** (any thread): enqueue into a bounded ingress queue; past
  ``serve.max_queue`` the request is refused at once (``shed_policy=
  "reject"``) with :class:`ServeRejected`, never blocking the caller.
- **dispatcher thread**: coalesce a batch (the first request waits at most
  ``batch_timeout_ms``; a full batch never waits; a second request of a
  session already in the batch is deferred to the next tick), admit new
  sessions into the LRU :class:`SlotPool` (evicted sessions restart cold),
  and enqueue the tick's device programs: the COLD program (batched
  prefill) for fresh sessions, the WARM program (per-row-clock incremental
  step) for sessions with a slot. Each program gathers its rows' carries
  from the arena, runs the model and scatters them back. Nothing here
  waits for the device: PyTorch enqueues CUDA work asynchronously, and
  host inputs go up from pinned memory without a synchronising copy.
- **consumer thread**: device readback, request completion (events +
  callbacks) and latency accounting. The dispatcher->consumer queue is
  bounded, so in-flight device buffers are bounded.

Inference runs under ``torch.inference_mode()``.

Not yet ported (refused when configured, see :func:`_refuse_unported`):
per-request deadlines, ``shed_policy="oldest"``, supervised restarts, the
warm host tier and the spill tier. Also absent: the weight-swap watcher
(there are no checkpoints in the port yet; ``serve.swap_poll_s`` is unused),
SLO burn gauges, exemplars, histograms and live knobs.
"""

from __future__ import annotations

import math
import queue
import threading
import time
from collections import OrderedDict, deque
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from sharetrade_tpu_torch.config import ConfigError, ServeConfig
from sharetrade_tpu_torch.precision import FP32, PrecisionPolicy
from sharetrade_tpu_torch.utils.logging import get_logger

log = get_logger("serve")

_SHUTDOWN = object()
#: Dispatched ticks the consumer may lag behind (bounds in-flight buffers).
_DONE_DEPTH = 4
#: Checkpoint step of the served weights: checkpoints are not ported yet,
#: so every response comes from the weights the engine was built with.
PARAMS_STEP = 0


class ServeRejected(RuntimeError):
    """The request was refused admission: the ingress queue was at
    ``serve.max_queue``. Delivered as a completed handle (``wait()``
    returns None, ``error`` carries this)."""

    def __init__(self, message: str, *, reason: str):
        super().__init__(message)
        self.reason = reason


def latency_percentiles(values) -> dict[str, float]:
    """p50/p99/mean over a latency sample — nearest rank, rank =
    ceil(q * n), 1-indexed (the JAX serving tier's one convention)."""
    if not len(values):
        return {"p50_ms": 0.0, "p99_ms": 0.0, "mean_ms": 0.0}
    arr = np.sort(np.asarray(values, np.float64))
    n = len(arr)

    def nearest_rank(q: float) -> float:
        return float(arr[min(max(math.ceil(q * n), 1), n) - 1])

    return {"p50_ms": nearest_rank(0.50), "p99_ms": nearest_rank(0.99),
            "mean_ms": float(arr.mean())}


class ServeResult(NamedTuple):
    """One completed inference. ``stages`` splits ``latency_ms`` into
    ``queue_wait_ms`` + ``batch_wait_ms`` + ``device_ms``."""

    session_id: Any
    action: int
    logits: np.ndarray
    value: float
    params_step: int
    latency_ms: float
    stages: dict | None = None


class _Request:
    __slots__ = ("session_id", "obs", "t_enq", "t_collected",
                 "t_dispatched", "callback", "_event", "result", "error")

    def __init__(self, session_id: Any, obs: np.ndarray,
                 callback: Callable[[ServeResult | None], None] | None):
        self.session_id = session_id
        self.obs = obs
        self.t_enq = time.perf_counter()
        self.t_collected: float | None = None
        self.t_dispatched: float | None = None
        self.callback = callback
        self._event = threading.Event()
        self.result: ServeResult | None = None
        self.error: BaseException | None = None

    def wait(self, timeout: float | None = None) -> ServeResult | None:
        """Block until the response is ready; None on timeout or failure
        (then :attr:`error` carries the cause)."""
        self._event.wait(timeout)
        return self.result


class _DoneBatch(NamedTuple):
    groups: list          # [(reqs, actions, logits, values)] on the device
    n: int


class SlotPool:
    """Host-side session -> slot map with LRU eviction. ``admit`` never
    evicts a session pinned by the current batch; with ``capacity >=
    max_batch`` an unpinned victim or a free slot always exists."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self._lru: OrderedDict[Any, int] = OrderedDict()  # oldest first
        self._free = list(range(capacity))

    def __len__(self) -> int:
        return len(self._lru)

    def lookup(self, session_id: Any) -> int | None:
        """Slot of a warm session (refreshes its recency), else None."""
        slot = self._lru.get(session_id)
        if slot is not None:
            self._lru.move_to_end(session_id)
        return slot

    def drop(self, session_id: Any) -> None:
        slot = self._lru.pop(session_id, None)
        if slot is not None:
            self._free.append(slot)

    def admit(self, session_id: Any, pinned: set) -> tuple[int, Any | None]:
        """Assign a slot to a new session; returns ``(slot, evicted_sid)``."""
        if self._free:
            slot = self._free.pop()
            self._lru[session_id] = slot
            return slot, None
        for victim in self._lru:                       # oldest first
            if victim not in pinned:
                slot = self._lru.pop(victim)
                self._lru[session_id] = slot
                return slot, victim
        raise RuntimeError("slot pool exhausted by pinned sessions")


def _refuse_unported(cfg: ServeConfig) -> None:
    checks = {
        "shed_policy": cfg.shed_policy != "reject",
        "default_deadline_ms": cfg.default_deadline_ms != 0,
        "max_restarts": cfg.max_restarts != 0,
        "warm_bytes": cfg.warm_bytes != 0,
        "spill_dir": bool(cfg.spill_dir),
    }
    for knob, set_ in checks.items():
        if set_:
            raise ConfigError(f"serve.{knob}={getattr(cfg, knob)!r} is not "
                              "yet ported to sharetrade_tpu_torch")


def _fire(callback, result) -> None:
    """Run a request's completion callback; a failing callback is logged
    and never takes down the thread that completes requests."""
    if callback is None:
        return
    try:
        callback(result)
    except Exception:   # noqa: BLE001
        log.exception("serve callback failed")


def _tree_map(fn, *trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in first}
    return fn(*trees)


class ServeEngine:
    """Construct, :meth:`warmup`, submit from any thread, :meth:`stop`."""

    def __init__(self, model: Any, cfg: ServeConfig, params: Any, *,
                 precision: PrecisionPolicy = FP32):
        if cfg.max_batch < 1:
            raise ConfigError(
                f"serve.max_batch must be >= 1, got {cfg.max_batch}")
        if cfg.slots < cfg.max_batch:
            raise ConfigError(
                f"serve.slots ({cfg.slots}) must be >= serve.max_batch "
                f"({cfg.max_batch}): every session of a full batch needs a "
                "live slot")
        if cfg.batch_timeout_ms < 0:
            raise ConfigError(f"serve.batch_timeout_ms must be >= 0, got "
                              f"{cfg.batch_timeout_ms}")
        if cfg.max_queue < 1:
            raise ConfigError(f"serve.max_queue must be >= 1, got "
                              f"{cfg.max_queue}")
        _refuse_unported(cfg)
        if model.apply_prefill is None or model.apply_serve_batch is None:
            raise ConfigError(f"model {model.name!r} has no serving pair "
                              "(apply_prefill / apply_serve_batch)")
        self.model = model
        self.cfg = cfg
        self.device = model.device        # params and arena live with it
        self._pin = self.device.type == "cuda"
        with torch.inference_mode():
            self._params = precision.cast_compute(params)
            carry0 = precision.cast_carry(model.init_carry(), model)
            n_arena = cfg.slots + cfg.max_batch
            # The arena: one carry row per slot + max_batch scratch rows.
            self._pool = _tree_map(
                lambda x: x.to(self.device)[None].repeat(
                    (n_arena,) + (1,) * x.ndim).contiguous(), carry0)
        self._slots = SlotPool(cfg.slots)

        self._q: queue.Queue = queue.Queue(maxsize=cfg.max_queue)
        self._deferred: deque[_Request] = deque()
        self._done_q: queue.Queue = queue.Queue(maxsize=_DONE_DEPTH)
        self._stop_event = threading.Event()
        self._pending = 0
        self._lock = threading.Lock()
        #: Counters: requests, completed, failed, rejected, batches,
        #: cold_batches/warm_batches (device programs run), cold_rows/
        #: warm_rows (real rows served by each), evictions.
        self.counters: dict[str, int] = dict.fromkeys(
            ("requests", "completed", "failed", "rejected", "batches",
             "cold_batches", "warm_batches", "cold_rows", "warm_rows",
             "evictions"), 0)

        self._dispatcher = threading.Thread(
            target=self._serve_loop, name="serve-dispatcher", daemon=True)
        self._consumer = threading.Thread(
            target=self._complete_loop, name="serve-consumer", daemon=True)
        self._dispatcher.start()
        self._consumer.start()

    # -- device programs --------------------------------------------------

    def _warm_program(self, obs, idx):
        """One incremental step for a warm batch: gather, step, scatter."""
        rows = _tree_map(lambda p: p.index_select(0, idx), self._pool)
        out, new_rows = self.model.apply_serve_batch(self._params, obs, rows)
        _tree_map(lambda p, r: p.index_copy_(0, idx, r), self._pool,
                  new_rows)
        return out.logits.argmax(dim=-1), out.logits, out.value

    def _cold_program(self, obs, idx):
        """Batched prefill for fresh (or evicted) sessions; their carries
        land in their slots."""
        out, new_rows = self.model.apply_prefill(self._params, obs)
        _tree_map(lambda p, r: p.index_copy_(0, idx, r.to(p.dtype)),
                  self._pool, new_rows)
        return out.logits.argmax(dim=-1), out.logits, out.value

    def _upload(self, array: np.ndarray) -> torch.Tensor:
        host = torch.from_numpy(array)
        if not self._pin:
            return host
        return host.pin_memory().to(self.device, non_blocking=True)

    # -- public surface ---------------------------------------------------

    def submit(self, session_id: Any, obs: Any,
               callback: Callable[[ServeResult | None], None] | None = None
               ) -> _Request:
        """Enqueue one query; thread-safe and never blocking. Returns a
        handle whose ``wait()`` blocks for the response; ``callback(result)``
        also fires on the consumer thread (with None on failure)."""
        if self._stop_event.is_set():
            raise RuntimeError("serve engine is stopped")
        req = _Request(session_id, np.asarray(obs, np.float32), callback)
        with self._lock:
            self._pending += 1
            self.counters["requests"] += 1
        try:
            self._q.put_nowait(req)
        except queue.Full:
            with self._lock:
                self.counters["rejected"] += 1
            self._finish_failed(req, ServeRejected(
                f"ingress queue full ({self.cfg.max_queue}); request "
                "rejected under shed_policy='reject'", reason="queue_full"))
        return req

    def warmup(self) -> None:
        """Run both programs once on scratch rows (live slots untouched),
        so the first real request pays no kernel build or first launch.
        Must run before concurrent submits."""
        cfg = self.cfg
        obs = self._upload(np.full((cfg.max_batch, self.model.obs_dim), 10.0,
                                   np.float32))
        idx = self._upload(np.arange(cfg.slots, cfg.slots + cfg.max_batch,
                                     dtype=np.int64))
        with torch.inference_mode():
            self._cold_program(obs, idx)
            self._warm_program(obs, idx)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def drain(self, timeout_s: float = 30.0) -> bool:
        """Block until every submitted request has been answered."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            with self._lock:
                if self._pending == 0:
                    return True
            time.sleep(0.002)
        with self._lock:
            return self._pending == 0

    def stop(self, *, drain: bool = True, timeout_s: float = 30.0) -> bool:
        """Drain (optionally) and stop both threads; False when a thread is
        still alive after its join timeout."""
        if drain:
            self.drain(timeout_s)
        self._stop_event.set()
        self._dispatcher.join(timeout_s)
        if not self._dispatcher.is_alive():
            self._fail_leftovers()
        try:
            self._done_q.put(_SHUTDOWN, timeout=timeout_s)
        except queue.Full:
            pass
        self._consumer.join(timeout_s)
        return not (self._dispatcher.is_alive() or self._consumer.is_alive())

    # -- dispatcher thread ------------------------------------------------

    def _serve_loop(self) -> None:
        with torch.inference_mode():
            while not self._stop_event.is_set():
                batch = self._collect_batch()
                if not batch:
                    continue
                try:
                    done = self._dispatch_batch(batch)
                except Exception as exc:   # noqa: BLE001 — fail the batch,
                    # keep serving the sessions of later batches.
                    log.exception("serve dispatch failed for a %d-request "
                                  "batch", len(batch))
                    for req in batch:
                        self._slots.drop(req.session_id)
                        self._finish_failed(req, exc)
                    continue
                self._done_q.put(done)
        self._fail_leftovers()

    def _collect_batch(self) -> list[_Request]:
        """Deferred same-session requests first, then the queue until
        ``max_batch`` or the coalescing deadline anchored at the first
        request."""
        cfg = self.cfg
        batch: list[_Request] = []
        seen: set = set()
        kept: deque[_Request] = deque()
        now = time.perf_counter()
        while self._deferred:
            req = self._deferred.popleft()
            if req.session_id in seen or len(batch) >= cfg.max_batch:
                kept.append(req)
            else:
                req.t_collected = now
                batch.append(req)
                seen.add(req.session_id)
        self._deferred = kept
        if not batch:
            try:
                req = self._q.get(timeout=0.05)
            except queue.Empty:
                return []
            req.t_collected = time.perf_counter()
            batch.append(req)
            seen.add(req.session_id)
        deadline = time.perf_counter() + cfg.batch_timeout_ms / 1e3
        while len(batch) < cfg.max_batch:
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                break
            try:
                req = self._q.get(timeout=remaining)
            except queue.Empty:
                break
            if req.session_id in seen:
                self._deferred.append(req)
                continue
            req.t_collected = time.perf_counter()
            batch.append(req)
            seen.add(req.session_id)
        return batch

    def _dispatch_batch(self, batch: list[_Request]) -> _DoneBatch:
        """Admit, split cold/warm, enqueue the tick's program(s)."""
        pinned = {r.session_id for r in batch}
        cold_reqs, cold_idx, warm_reqs, warm_idx = [], [], [], []
        evicted = 0
        for req in batch:
            slot = self._slots.lookup(req.session_id)
            if slot is not None:
                warm_reqs.append(req)
                warm_idx.append(slot)
                continue
            slot, victim = self._slots.admit(req.session_id, pinned)
            evicted += victim is not None
            cold_reqs.append(req)
            cold_idx.append(slot)
        groups = []
        for reqs, idx, program, key in (
                (cold_reqs, cold_idx, self._cold_program, "cold"),
                (warm_reqs, warm_idx, self._warm_program, "warm")):
            if not reqs:
                continue
            obs, pidx = self._pad(reqs, idx)
            t = time.perf_counter()
            for req in reqs:
                req.t_dispatched = t
            act, logits, values = program(self._upload(obs),
                                          self._upload(pidx))
            groups.append((reqs, act, logits, values))
            with self._lock:
                self.counters[f"{key}_batches"] += 1
                self.counters[f"{key}_rows"] += len(reqs)
        with self._lock:
            self.counters["batches"] += 1
            self.counters["evictions"] += evicted
        return _DoneBatch(groups=groups, n=len(batch))

    def _pad(self, reqs: list[_Request],
             idx: list[int]) -> tuple[np.ndarray, np.ndarray]:
        """Pad a group to the static ``max_batch`` shape: padding rows
        repeat the first observation and index SCRATCH arena rows."""
        cfg = self.cfg
        obs = np.empty((cfg.max_batch, reqs[0].obs.shape[-1]), np.float32)
        out_idx = np.empty((cfg.max_batch,), np.int64)
        for i, req in enumerate(reqs):
            obs[i] = req.obs
            out_idx[i] = idx[i]
        obs[len(reqs):] = reqs[0].obs
        out_idx[len(reqs):] = np.arange(cfg.slots + len(reqs),
                                        cfg.slots + cfg.max_batch)
        return obs, out_idx

    def _fail_leftovers(self) -> None:
        leftover = RuntimeError(
            "serve engine stopped before this request was dispatched")
        while True:
            try:
                req = self._deferred.popleft()
            except IndexError:
                break
            self._finish_failed(req, leftover)
        while True:
            try:
                req = self._q.get_nowait()
            except queue.Empty:
                break
            self._finish_failed(req, leftover)

    def _finish_failed(self, req: _Request, exc: BaseException) -> None:
        with self._lock:
            self._pending -= 1
            self.counters["failed"] += 1
        req.error = exc
        req._event.set()
        _fire(req.callback, None)

    # -- consumer thread --------------------------------------------------

    def _complete_loop(self) -> None:
        while True:
            try:
                item = self._done_q.get(timeout=0.2)
            except queue.Empty:
                if (self._stop_event.is_set()
                        and not self._dispatcher.is_alive()
                        and self._done_q.empty()):
                    return
                continue
            if item is _SHUTDOWN:
                return
            self._complete_batch(item)

    def _complete_batch(self, done: _DoneBatch) -> None:
        """Readback + completion; blocking host work belongs here."""
        n_done = 0
        try:
            for reqs, act_dev, logit_dev, val_dev in done.groups:
                actions = act_dev.cpu().numpy()
                logits = logit_dev.cpu().numpy()
                values = val_dev.cpu().numpy()
                now = time.perf_counter()
                for i, req in enumerate(reqs):
                    t_coll = req.t_collected or req.t_enq
                    t_disp = req.t_dispatched or t_coll
                    stages = {"queue_wait_ms": (t_coll - req.t_enq) * 1e3,
                              "batch_wait_ms": (t_disp - t_coll) * 1e3,
                              "device_ms": (now - t_disp) * 1e3}
                    result = ServeResult(
                        session_id=req.session_id, action=int(actions[i]),
                        logits=logits[i], value=float(values[i]),
                        params_step=PARAMS_STEP,
                        latency_ms=(now - req.t_enq) * 1e3, stages=stages)
                    req.result = result
                    req._event.set()
                    n_done += 1
                    _fire(req.callback, result)
        except Exception as exc:   # noqa: BLE001 — a readback fault fails
            # the batch's remaining requests instead of stranding them.
            log.exception("serve consumer failed completing a batch")
            for reqs, *_ in done.groups:
                for req in reqs:
                    if not req._event.is_set():
                        req.error = exc
                        req._event.set()
                        _fire(req.callback, None)
        finally:
            with self._lock:
                self._pending -= done.n
                self.counters["completed"] += n_done
                self.counters["failed"] += done.n - n_done
