"""Continuous-batching inference engine over a session slot arena.

Counterpart of the JAX package's ``serve/engine.py``: per-user
``(window, portfolio)`` queries are coalesced into padded device batches
under a deadline (``serve.max_batch`` / ``serve.batch_timeout_ms``), and each
session's recurrent carry (the episode transformer's K/V ring, the LSTM's
``(h, c)``; any tree of dicts, lists and tuples) lives in a
device-resident ARENA of ``slots + max_batch`` rows — one row per slot plus
``max_batch`` scratch rows that padding rows read and write, so a partial
batch never touches a live session.

Structure (the JAX engine's dispatcher/consumer split):

- **submit** (any thread): enqueue into the ingress queue, bounded at
  ``serve.max_queue``. Past the bound the new request is refused
  (``shed_policy="reject"``) or the oldest queued one is shed
  (``"oldest"``); the loser completes at once with :class:`ServeRejected`.
  Never blocks the caller.
- **dispatcher thread**: coalesce a batch (the first request waits at most
  ``batch_timeout_ms``, clamped to the earliest surviving request's
  deadline; a full batch never waits; requests already queued join past
  that deadline, so a zero timeout still batches a backlog, where the JAX
  engine takes one request a tick; a second request of a session already
  in the batch is deferred to the next tick; an expired request completes
  with :class:`ServeDeadlineExceeded` before it can take a row), admit new
  sessions into the LRU :class:`SlotPool`, and enqueue the tick's device
  programs: the COLD program (batched prefill) for fresh sessions, the WARM
  program (per-row-clock incremental step) for sessions with a slot. Each
  program gathers its rows' carries from the arena, runs the model and
  scatters them back (``index_copy_``). A model without a prefill/serve
  pair (the MLPs, the LSTM, the TCN, the window transformer) runs ONE
  GENERIC program per tick instead: cold rows take the init carry inside
  the program, then every row runs ``model.apply_batch``. The weights are
  read ONCE per tick (:class:`_Live`: params and their checkpoint step),
  so a tick never computes under two sets of weights, and every
  :class:`ServeResult` names the step that computed it. Nothing here waits
  for the device: PyTorch enqueues CUDA work asynchronously, and host
  inputs go up from pinned memory without a synchronising copy.
- **consumer thread**: device readback, request completion (events +
  callbacks) and the spill tier's disk I/O. The dispatcher->consumer queue
  is bounded, so in-flight device buffers are bounded.

Every CUDA operation of both threads goes on the device's current (default)
stream, so the arena's in-place writes, the page-out gathers, the installs
and the readbacks are ordered by the stream itself. Only the page-out's
device-to-host copies run on a stream of their own, after an event that
follows their gather.

Weight swaps (:meth:`ServeEngine.swap_params`, called by
``serve/swap.py``'s watcher) replace one ``(params, step)`` reference
between ticks; the new compute copy is complete on the device before it is
published, and the old one stays referenced by the ticks that read it until
the consumer has read them back.

Supervision (``serve.max_restarts > 0``): a dispatch or consumer fault
fails its batch, then the engine is rebuilt (fresh slot pool, fresh arena,
warmed up again) under seeded exponential backoff that waits on the stop
event; sessions re-enter cold through the batched prefill. More than
``max_restarts`` consecutive faults trip a terminal failed state in which
queued and later work fails loudly with :class:`ServeEngineFailed`. A
sticky CUDA error makes every rebuild fail, so such a fault storm ends in
the terminal state rather than a spin.

Session tiers (``serve.warm_bytes``, ``serve.spill_dir``), for models with
a carry:

- **hot**: a slot of the arena.
- **warm**: an evicted session's carry rows are gathered on the dispatcher
  into one packed byte row per session (``index_select`` and a ``cat``:
  new tensors, enqueued before the tick's scatters into the same slots,
  and referenced until copied), copied on the copy stream into the
  session's own pinned host row (the layout of a spill record's payload),
  and parked in :class:`WarmStore`, a byte-budgeted host LRU, once the
  copy's event has passed. A request of a session whose page-out is still
  in flight waits for it. A returning session's parked row is copied up
  into a staging row, split into its leaves and scattered back through
  the same ``index_copy_`` path, so it continues bit for bit as a session
  that was never evicted, through the warm program (no prefill, no
  ``flash_fwd``).
- **spill**: the warm store's overflow, and at ``page_out_all`` every
  surviving carry, sealed into a crash-consistent on-disk arena
  (``serve/spill.py``: CRC, step stamp, atomic rename; the JAX package's
  record format), which another engine of either package can adopt. The
  disk I/O rides the consumer; the dispatcher only probes with
  ``os.stat``. A stale, torn or CRC-bad record lands cold.
- **cold**: everything else: the batched prefill.

Counters (``MetricsRegistry``, the JAX names): ``serve_requests_total``,
``serve_responses_total``, ``serve_batches_total``,
``serve_prefills_total``, ``serve_evictions_total``,
``serve_queue_rejected_total``, ``serve_shed_total``,
``serve_deadline_expired_total``, ``serve_restarts_total``,
``serve_swaps_total``, the warm tier's ``serve_warm_*_total`` and the
spill tier's ``serve_spill_*_total`` / ``serve_adopt_*_total``; gauges
``serve_overload`` and ``serve_failed``. ``engine.counters`` keeps the
port's own per-program counts.

Telemetry (the JAX engine's SLO side). Every request carries its lifecycle
stamps (enqueued, collected, dispatched, device, done; deferrals, the cold
flag, the tick serial, the outcome), and they telescope: ``queue_wait +
batch_wait + device == latency_ms`` for every completed request, checked
per request (``serve_trace_decomposition_error_total`` stays 0). Five
histograms (``obs/hist.py``, the JAX bucket layout) are attached to the
registry: ``serve_request_ms`` and ``serve_{queue_wait,batch_wait,device,
readback}_ms``. Every ``serve.stats_interval_s`` the consumer publishes
``serve_qps``, ``serve_queue_depth``, ``serve_overload``, the windowed
``serve_p50_ms`` / ``serve_p99_ms`` (quantiles of the end-to-end
histogram's bucket delta over the window), ``serve_batch_occupancy``,
``serve_sessions_hot``, the warm tier's gauges (``serve_warm_econ_ms_per_mb``
prices its hits at an EWMA of the cold re-entry's device ms) and the spill
tier's, and, with ``obs.slo_availability`` / ``obs.slo_target_p99_ms`` set,
the burn rates ``serve_slo_availability_burn`` / ``serve_slo_latency_burn``
over ``obs.slo_window_s`` (``serve_slo_burn_alerts_total`` counts crossings
of ``obs.slo_burn_threshold``, re-armed below half of it). Failure paths
(shed, reject, expiry, a failed engine) publish from their own threads
without blocking, so the availability burn climbs during an outage in
which nothing completes. The ``obs.exemplar_k`` slowest requests of each
window, with their stage split, fold into a bounded ring
(:meth:`ServeEngine.exemplars`).

Live knobs: :meth:`ServeEngine.set_knobs` (the online controller's
actuator, ``serve/controller.py``) swaps ``batch_timeout_ms`` and
``max_queue`` as one reference, clamped to the configured values, and
retargets the ingress bound; batch collection reads the live vector once a
tick. The JAX engine's ``obs`` facade (span trace, flight recorder,
``serve_exemplars.json``) is not ported: the port runs as the JAX engine
does with ``obs=None``, with no exemplar file, no flight event and no
per-request span.

Inference runs under ``torch.inference_mode()``.
"""

from __future__ import annotations

import math
import os
import queue
import random
import threading
import time
from collections import OrderedDict, deque
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from sharetrade_tpu_torch.config import ConfigError, ServeConfig
from sharetrade_tpu_torch.models.core import tree_leaves, tree_map
from sharetrade_tpu_torch.obs import SERVE_STAGES
from sharetrade_tpu_torch.obs.hist import Histogram
from sharetrade_tpu_torch.precision import FP32, PrecisionPolicy
from sharetrade_tpu_torch.serve.spill import SpillArena
from sharetrade_tpu_torch.utils.logging import get_logger
from sharetrade_tpu_torch.utils.metrics import MetricsRegistry

log = get_logger("serve")

_SHUTDOWN = object()
#: Done-queue nudge: the dispatcher enqueues spill ops for the consumer and
#: pokes this (best-effort) so an idle consumer runs them now.
_SPILL_TICK = object()
#: Dispatched ticks the consumer may lag behind (bounds in-flight buffers).
_DONE_DEPTH = 4


class ServeRejected(RuntimeError):
    """The request was refused admission (``shed_policy="reject"``) or shed
    from the queue under overload (``"oldest"``). Delivered as a completed
    handle (``wait()`` returns None, ``error`` carries this); ``reason`` is
    ``"queue_full"`` / ``"shed_oldest"`` / ``"deferred_overflow"``."""

    def __init__(self, message: str, *, reason: str):
        super().__init__(message)
        self.reason = reason


class ServeDeadlineExceeded(RuntimeError):
    """The request's deadline (``submit(..., deadline_ms=)`` or
    ``serve.default_deadline_ms``) expired before it reached a batch."""


class ServeEngineFailed(RuntimeError):
    """More than ``serve.max_restarts`` consecutive faults: the engine is
    terminally failed and every queued and later request fails with this."""


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
    """One completed inference. ``params_step`` names the checkpoint whose
    weights computed it; ``stages`` splits ``latency_ms`` into
    ``queue_wait_ms`` + ``batch_wait_ms`` + ``device_ms``; ``batch`` is the
    serial of the dispatcher tick that served it."""

    session_id: Any
    action: int
    logits: np.ndarray
    value: float
    params_step: int
    latency_ms: float
    stages: dict | None = None
    batch: int | None = None


class _Live(NamedTuple):
    """The serving weights as one reference, swapped whole and read once
    per tick."""

    params: Any
    step: int


class _LiveKnobs(NamedTuple):
    """The engine's runtime-tunable knobs as one reference, swapped whole
    by :meth:`ServeEngine.set_knobs` and read once per decision site. The
    configured values are the ceilings."""

    batch_timeout_ms: float
    max_queue: int


class _Request:
    """A submitted query and its lifecycle stamps (``perf_counter``): they
    telescope, so ``queue_wait`` (t_enq -> t_collected) + ``batch_wait``
    (t_collected -> t_dispatched) + ``device`` (t_dispatched -> t_device,
    the device work and its readback) is the latency; ``readback``
    (t_device -> t_done) is the completion on top. An edge never reached
    stays None (a shed request is never collected)."""

    __slots__ = ("session_id", "obs", "t_enq", "t_deadline", "t_collected",
                 "t_dispatched", "t_device", "t_done", "deferrals", "cold",
                 "batch", "outcome", "callback", "_event", "result", "error",
                 "clock")

    def __init__(self, session_id: Any, obs: np.ndarray,
                 callback: Callable[[ServeResult | None], None] | None,
                 deadline_ms: float = 0.0, clock: int | None = None):
        self.session_id = session_id
        self.obs = obs
        self.t_enq = time.perf_counter()
        # A negative deadline (a budget already spent) is already expired.
        self.t_deadline = (self.t_enq + max(deadline_ms, 0.0) / 1e3
                           if deadline_ms else None)
        self.t_collected: float | None = None
        self.t_dispatched: float | None = None
        self.t_device: float | None = None
        self.t_done: float | None = None
        self.deferrals = 0          # ticks waited out in the deferred queue
        self.cold = False           # served from the init carry / prefill
        self.batch: int | None = None   # serial of the tick that served it
        self.outcome: str | None = None
        self.callback = callback
        self._event = threading.Event()
        self.result: ServeResult | None = None
        self.error: BaseException | None = None
        #: The session's expected step clock (its completed-response count)
        #: for adopting a spilled carry; None: local submit, adoption only
        #: of this engine incarnation's own records.
        self.clock = clock

    def wait(self, timeout: float | None = None) -> ServeResult | None:
        """Block until the response is ready; None on timeout or failure
        (then :attr:`error` carries the cause)."""
        self._event.wait(timeout)
        return self.result


class _PageOut(NamedTuple):
    """One tick's page-out in flight: the victims, their stamps, the pinned
    host carries the copies land in, the packed device rows they are read
    from (kept alive until the copies end) and the events around it."""

    sids: list
    steps: list
    rows: list
    packed: Any
    events: tuple         # (gather start, gather end, copy start, copy end)


class _DoneBatch(NamedTuple):
    """One dispatched tick, dispatcher -> consumer."""

    groups: list          # [(reqs, actions, logits, values)] on the device
    live: _Live           # the weights the tick read (kept alive until read)
    n: int
    serial: int
    cold: int
    evicted: int
    #: Supervision fault epoch at dispatch: only a batch dispatched after
    #: the latest fault may reset the consecutive-fault streak.
    epoch: int = 0
    #: CUDA events around the tick's install (device timing; None on the
    #: CPU or when the tick installed nothing), and the pinned host carries
    #: it copied up, held until the tick is read back.
    install_events: tuple | None = None
    installed: tuple = ()


class SlotPool:
    """Host-side session -> slot map with LRU eviction. ``admit`` never
    evicts a session pinned by the current batch; with ``capacity >=
    max_batch`` an unpinned victim or a free slot always exists."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self._lru: OrderedDict[Any, int] = OrderedDict()  # oldest first
        self._free = list(range(capacity))
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._lru)

    def lookup(self, session_id: Any) -> int | None:
        """Slot of a hot session (refreshes its recency), else None."""
        slot = self._lru.get(session_id)
        if slot is not None:
            self._lru.move_to_end(session_id)
        return slot

    def contains(self, session_id: Any) -> bool:
        """Membership without a recency refresh."""
        return session_id in self._lru

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
                self.evictions += 1
                return slot, victim
        raise RuntimeError("slot pool exhausted by pinned sessions")


class WarmStore:
    """The warm tier: a byte-budgeted LRU of parked carries (host trees of
    CPU tensors), owned by the dispatcher thread alone. Every ``put``
    demotes stalest-first until both the byte budget and the session bound
    hold; a carry larger than the whole budget is refused."""

    def __init__(self, max_bytes: int, max_sessions: int):
        self.max_bytes = int(max_bytes)
        self.max_sessions = max(1, int(max_sessions))
        #: session -> (rows, nbytes, steps): the carry, its footprint and
        #: the session's dispatched-step stamp at park time.
        self._lru: OrderedDict[Any, tuple[Any, int, int]] = OrderedDict()
        self.bytes = 0
        self.demotions = 0
        self.refusals = 0
        self.stale_drops = 0

    def __len__(self) -> int:
        return len(self._lru)

    def contains(self, session_id: Any) -> bool:
        return session_id in self._lru

    def pop(self, session_id: Any) -> tuple[Any, int] | None:
        """Remove and return a parked ``(carry, steps)`` (a warm hit), or
        None on a miss."""
        entry = self._lru.pop(session_id, None)
        if entry is None:
            return None
        rows, nbytes, steps = entry
        self.bytes -= nbytes
        return rows, steps

    def discard(self, session_id: Any) -> None:
        """Forget a parked carry without returning it."""
        self.pop(session_id)

    def put(self, session_id: Any, rows: Any, nbytes: int,
            steps: int = 0) -> list:
        """Park one carry; returns the entries demoted to make room
        (stalest first, as ``(session, rows, nbytes, steps)``). A carry
        that cannot fit the budget at all is refused."""
        nbytes = int(nbytes)
        if nbytes <= 0 or nbytes > self.max_bytes:
            self.refusals += 1
            return []
        old = self._lru.pop(session_id, None)
        if old is not None:
            self.bytes -= old[1]
        self._lru[session_id] = (rows, nbytes, int(steps))
        self.bytes += nbytes
        demoted = []
        while (self.bytes > self.max_bytes
               or len(self._lru) > self.max_sessions):
            victim, (vrows, vbytes, vsteps) = self._lru.popitem(last=False)
            self.bytes -= vbytes
            self.demotions += 1
            demoted.append((victim, vrows, vbytes, vsteps))
        return demoted


def _outcome(exc: BaseException) -> str:
    """A failed request's outcome name, as the JAX engine's traces name
    it."""
    if isinstance(exc, ServeRejected):
        return exc.reason
    if isinstance(exc, ServeDeadlineExceeded):
        return "expired"
    if isinstance(exc, ServeEngineFailed):
        return "engine_failed"
    return "failed"


def _fire(callback, result) -> None:
    """Run a request's completion callback; a failing callback is logged
    and never takes down the thread that completes requests."""
    if callback is None:
        return
    try:
        callback(result)
    except Exception:   # noqa: BLE001
        log.exception("serve callback failed")


def _validate(cfg: ServeConfig) -> None:
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
    if cfg.shed_policy not in ("reject", "oldest"):
        raise ConfigError(f"serve.shed_policy must be 'reject' or 'oldest', "
                          f"got {cfg.shed_policy!r}")
    if cfg.default_deadline_ms < 0:
        raise ConfigError(f"serve.default_deadline_ms must be >= 0 (0 = "
                          f"none), got {cfg.default_deadline_ms}")
    if cfg.max_restarts < 0:
        raise ConfigError(f"serve.max_restarts must be >= 0, got "
                          f"{cfg.max_restarts}")
    if cfg.restart_backoff_s <= 0 or cfg.restart_backoff_max_s <= 0:
        raise ConfigError(
            "serve.restart_backoff_s / restart_backoff_max_s must be > 0, "
            f"got {cfg.restart_backoff_s}/{cfg.restart_backoff_max_s}")
    if cfg.warm_bytes < 0:
        raise ConfigError(f"serve.warm_bytes must be >= 0 (0 disables the "
                          f"warm tier), got {cfg.warm_bytes}")
    if cfg.warm_max_sessions < 1:
        raise ConfigError(f"serve.warm_max_sessions must be >= 1, got "
                          f"{cfg.warm_max_sessions}")
    if cfg.spill_bytes < 0:
        raise ConfigError(f"serve.spill_bytes must be >= 0, got "
                          f"{cfg.spill_bytes}")
    if cfg.spill_dir and cfg.warm_bytes <= 0:
        raise ConfigError("serve.spill_dir requires the warm tier "
                          "(serve.warm_bytes > 0): the spill arena is the "
                          "warm store's overflow")


def _slo_settings(obs_cfg: Any) -> tuple[float, float, float, float]:
    """``(availability, target_p99_ms, window_s, burn_threshold)`` of an
    ``ObsConfig`` (None: the SLO off), refused as the JAX engine refuses
    them."""
    avail = float(getattr(obs_cfg, "slo_availability", 0.0) or 0.0)
    p99 = float(getattr(obs_cfg, "slo_target_p99_ms", 0.0) or 0.0)
    window = float(getattr(obs_cfg, "slo_window_s", 60.0))
    threshold = float(getattr(obs_cfg, "slo_burn_threshold", 2.0))
    if not 0.0 <= avail < 1.0:
        raise ConfigError(f"obs.slo_availability must be in [0, 1) (0 "
                          f"disables), got {avail}")
    if p99 < 0 or window <= 0 or threshold <= 0:
        raise ConfigError(
            "obs.slo_target_p99_ms must be >= 0 and slo_window_s / "
            f"slo_burn_threshold > 0, got {p99}/{window}/{threshold}")
    return avail, p99, window, threshold


class ServeEngine:
    """Construct, :meth:`warmup`, submit from any thread, :meth:`stop`."""

    def __init__(self, model: Any, cfg: ServeConfig, params: Any, *,
                 params_step: int = 0, precision: PrecisionPolicy = FP32,
                 registry: MetricsRegistry | None = None,
                 obs_cfg: Any = None,
                 done_depth: int = _DONE_DEPTH,
                 restart_seed: int | None = None):
        _validate(cfg)
        slo = _slo_settings(obs_cfg)
        self._generic = (model.apply_prefill is None
                         or model.apply_serve_batch is None)
        if self._generic and model.apply_batch is None:
            raise ConfigError(f"model {model.name!r} has neither a serving "
                              "pair (apply_prefill / apply_serve_batch) nor "
                              "apply_batch")
        self.model = model
        self.cfg = cfg
        self._precision = precision
        self._registry = registry if registry is not None else MetricsRegistry()
        self.device = model.device        # params and arena live with it
        self._cuda = self.device.type == "cuda"
        #: The page-out copies' stream (they overlap the tick's programs).
        self._copy_stream = (torch.cuda.Stream(self.device) if self._cuda
                             else None)
        with torch.inference_mode():
            self._live = _Live(precision.cast_compute(params),
                               int(params_step))
            self._carry0 = precision.cast_carry(model.init_carry(), model)
        #: One session's carry in bytes: the warm tier's accounting unit and
        #: the spill record's payload length.
        self._carry_nbytes = sum(leaf.numel() * leaf.element_size()
                                 for leaf in tree_leaves(self._carry0))
        self._warm_enabled = cfg.warm_bytes > 0 and self._carry_nbytes > 0
        self._spill_enabled = bool(cfg.spill_dir) and self._warm_enabled
        self._build_arena()

        # The live knobs, seeded from config (their ceiling) and moved by
        # set_knobs; the ingress bound follows max_queue.
        self._knobs = _LiveKnobs(batch_timeout_ms=float(cfg.batch_timeout_ms),
                                 max_queue=int(cfg.max_queue))
        self._registry.record_many({
            "serve_knob_batch_timeout_ms": self._knobs.batch_timeout_ms,
            "serve_knob_max_queue": float(self._knobs.max_queue)})
        self._q: queue.Queue = queue.Queue(maxsize=cfg.max_queue)
        self._deferred: deque[_Request] = deque()
        self._done_q: queue.Queue = queue.Queue(maxsize=done_depth)
        #: Sessions whose carries a consumer fault left suspect, dropped by
        #: the dispatcher (which owns the slot pool).
        self._poisoned: deque = deque()
        self._stop_event = threading.Event()
        self._pending = 0
        self._lock = threading.Lock()
        #: Counters: requests, completed, failed, rejected, batches,
        #: cold_batches/warm_batches/generic_batches (device programs run),
        #: cold_rows/warm_rows (real rows served fresh and warm), evictions.
        self.counters: dict[str, int] = dict.fromkeys(
            ("requests", "completed", "failed", "rejected", "batches",
             "cold_batches", "warm_batches", "generic_batches", "cold_rows",
             "warm_rows", "evictions"), 0)
        #: Device milliseconds of the paging path (CUDA events): the park
        #: gather + its copy, and the install upload + scatter, summed,
        #: with the ticks they ran in.
        self._paging_ms = {"pageout": [0.0, 0], "install": [0.0, 0]}

        # Supervision: the consecutive-fault streak (the dispatcher counts,
        # the consumer resets), the fault epoch that gates those resets, a
        # consumer-side restart request and the terminal fault.
        self._restart_streak = 0
        self._sup_lock = threading.Lock()
        self._fault_epoch = 0
        self._restart_rng = random.Random(restart_seed)
        self._restart_requested = threading.Event()
        self._consumer_fault: BaseException | None = None
        self._consumer_fault_epoch = 0
        self._failed: BaseException | None = None
        self._batch_serial = 0

        # Stats windows (guarded by _lock): overload events, completions
        # and the sum and count of tick occupancies since the last
        # publish; the terminal-outcome totals the SLO burn windows diff.
        self._overload_events = 0
        self._stats_t = time.perf_counter()
        self._stats_completed = 0
        self._stats_occupancy = 0.0
        self._stats_ticks = 0
        self._term_total = self._term_bad = 0
        self._term_completed = self._term_slow = 0
        #: EWMA of a cold re-entry's device ms and the warm-hit count at the
        #: last publish: the warm tier's economics gauge.
        self._ewma_prefill_ms = 0.0
        self._prev_warm_hits = 0.0
        #: Serialises publishes: the consumer publishes after every batch,
        #: failure paths from their own threads (they skip when it is
        #: taken), stop() with force.
        self._stats_lock = threading.Lock()
        self._slo = slo
        self._slo_on = slo[0] > 0 or slo[1] > 0
        #: (t, total, bad, completed, slow) at each publish, seeded with
        #: zeros so an incident inside the first interval still burns.
        self._slo_win: deque[tuple] = deque(maxlen=4096)
        self._slo_win.append((self._stats_t, 0, 0, 0, 0))
        self._burn_alarm = False
        self._hists = {
            name: self._registry.attach_histogram(name, Histogram())
            for name in ("serve_request_ms",
                         *(f"serve_{s}_ms" for s in SERVE_STAGES))}
        self._h_e2e = self._hists["serve_request_ms"]
        #: End-to-end bucket counts at the last publish: the window delta
        #: the p50/p99 gauges are quantiles of.
        self._p50_prev_counts = self._h_e2e.snapshot()["counts"]
        #: The window's slowest requests (at most exemplar_k) and the ring
        #: of the last four windows' (guarded by _ex_lock; _stats_lock may
        #: take it, never the reverse).
        self._exemplar_k = max(0, int(getattr(obs_cfg, "exemplar_k", 8)
                                      if obs_cfg is not None else 8))
        self._window_slowest: list[dict] = []
        self._exemplars: deque[dict] = deque(
            maxlen=max(1, 4 * self._exemplar_k))
        self._ex_lock = threading.Lock()
        #: perf_counter of the last spill-arena scan (the stats cadence
        #: also bounds :meth:`refresh_spill_gauges`' scans).
        self._spill_scan_t = 0.0

        self._dispatcher = threading.Thread(
            target=self._serve_loop, name="serve-dispatcher", daemon=True)
        self._consumer = threading.Thread(
            target=self._complete_loop, name="serve-consumer", daemon=True)
        self._dispatcher.start()
        self._consumer.start()

    def _build_arena(self) -> None:
        """Fresh slot pool, warm store and device arena: construction and
        the supervised rebuild (every session then re-enters cold)."""
        cfg = self.cfg
        self._slots = SlotPool(cfg.slots)
        self._warm = WarmStore(cfg.warm_bytes, cfg.warm_max_sessions)
        #: Page-outs in flight (:class:`_PageOut`, in stream order), and the
        #: sessions they carry (dispatcher-owned): a request of such a
        #: session defers until its page-out is committed to the warm
        #: store, so a returning session always finds its parked carry.
        self._pageouts: deque = deque()
        self._parking: set = set()
        self._tick_victims: list = []
        #: Dispatched-step counts of hot sessions (the adoption clock that
        #: parks and spill records carry). Dispatcher-owned.
        self._steps: dict[Any, int] = {}
        #: Disk ops dispatcher -> consumer: ("put", sid, rows, steps),
        #: ("del", sid), ("take", sid, clock).
        self._spill_ops: deque = deque()
        #: Completed takes consumer -> dispatcher: (sid, rows|None, steps,
        #: reason).
        self._spill_inbox: deque = deque()
        #: Sessions with a take in flight: their requests defer.
        self._spill_inflight: set = set()
        #: Sessions with a put queued or running (dispatcher-owned counts),
        #: and the puts the consumer finished (consumer -> dispatcher): a
        #: request of a session whose carry is on its way to disk defers
        #: until the record is sealed, then adopts it.
        self._spill_putting: dict[Any, int] = {}
        self._spill_put_done: deque = deque()
        if self._spill_enabled:
            # A fresh incarnation per (re)build: without a session clock a
            # rebuilt engine adopts none of its predecessor's records.
            self._arena: SpillArena | None = SpillArena(
                cfg.spill_dir, max_bytes=cfg.spill_bytes,
                record_nbytes=self._carry_nbytes,
                incarnation=os.urandom(8).hex())
        else:
            self._arena = None
        n_arena = cfg.slots + cfg.max_batch
        with torch.inference_mode():
            self._pool = tree_map(
                lambda x: x.to(self.device)[None].repeat(
                    (n_arena,) + (1,) * x.ndim).contiguous(), self._carry0)
            # Per-row init carries for the generic program's cold reset.
            self._carry0_rows = tree_map(
                lambda x: x.to(self.device)[None].repeat(
                    (cfg.max_batch,) + (1,) * x.ndim).contiguous(),
                self._carry0)

    # -- device programs --------------------------------------------------

    def _warm_program(self, params, obs, idx):
        """One incremental step for a warm batch: gather, step, scatter."""
        rows = tree_map(lambda p: p.index_select(0, idx), self._pool)
        out, new_rows = self.model.apply_serve_batch(params, obs, rows)
        tree_map(lambda p, r: p.index_copy_(0, idx, r), self._pool,
                  new_rows)
        return out.logits.argmax(dim=-1), out.logits, out.value

    def _cold_program(self, params, obs, idx):
        """Batched prefill for fresh (or evicted) sessions; their carries
        land in their slots."""
        out, new_rows = self.model.apply_prefill(params, obs)
        tree_map(lambda p, r: p.index_copy_(0, idx, r.to(p.dtype)),
                  self._pool, new_rows)
        return out.logits.argmax(dim=-1), out.logits, out.value

    def _generic_program(self, params, obs, idx, cold):
        """One program for models without a prefill/serve pair: cold rows
        take the init carry, then every row runs ``model.apply_batch``."""
        rows = tree_map(
            lambda p, c: torch.where(
                cold.reshape((-1,) + (1,) * (c.ndim - 1)), c,
                p.index_select(0, idx)), self._pool, self._carry0_rows)
        out, new_rows = self.model.apply_batch(params, obs, rows)
        tree_map(lambda p, r: p.index_copy_(0, idx, r.to(p.dtype)),
                  self._pool, new_rows)
        return out.logits.argmax(dim=-1), out.logits, out.value

    def _park_gather(self, slots: list[int]) -> torch.Tensor:
        """The carries of ``slots`` as one new (n, carry bytes) uint8 device
        tensor: each row a session's leaves' raw bytes in tree-leaf order
        (the spill record's payload layout), enqueued before anything
        writes those slots."""
        idx = self._upload(np.asarray(slots, np.int64))
        return torch.cat([p.index_select(0, idx).reshape(len(slots), -1)
                          .view(torch.uint8)
                          for p in tree_leaves(self._pool)], dim=1)

    def _install(self, rows: list, slots: list[int]) -> None:
        """Unpark: each parked host carry (a flat byte row, pinned on the
        card) copied up into a staging row, asynchronously, then split
        into its leaves and scattered into the (re-)admitted slots through
        ``index_copy_``."""
        idx = self._upload(np.asarray(slots, np.int64))
        staging = torch.empty((len(rows), self._carry_nbytes),
                              dtype=torch.uint8, device=self.device)
        for i, row in enumerate(rows):
            staging[i].copy_(row, non_blocking=True)
        off = 0
        for p in tree_leaves(self._pool):
            nbytes = p[0].numel() * p.element_size()
            part = staging[:, off:off + nbytes].contiguous()
            p.index_copy_(0, idx, part.view(p.dtype).reshape(
                (len(rows),) + tuple(p.shape[1:])))
            off += nbytes

    def _start_page_out(self, sids: list, steps: list, slots: list[int]
                        ) -> None:
        """Page-out: gather the victims' rows on the main stream, then copy
        each into its own pinned host carry on the copy stream, which waits
        for the gather (an event) and so overlaps the tick's programs; the
        dispatcher commits the carries once the copy's event has passed."""
        rows, packed, events = self._copy_out(slots)
        self._pageouts.append(_PageOut(list(sids), list(steps), rows, packed,
                                       events))

    def _copy_out(self, slots: list[int]) -> tuple[list, Any, tuple]:
        """The page-out's device work: (pinned host rows, the packed device
        rows they are read from, the events around it)."""
        start = self._event()
        packed = self._park_gather(slots)
        gathered = self._event()
        rows = [torch.empty(self._carry_nbytes, dtype=torch.uint8,
                            pin_memory=self._cuda) for _ in slots]
        if self._cuda:
            self._copy_stream.wait_event(gathered)
            with torch.cuda.stream(self._copy_stream):
                copy_start = self._event()
                for i, row in enumerate(rows):
                    row.copy_(packed[i], non_blocking=True)
                events = (start, gathered, copy_start, self._event())
        else:
            for i, row in enumerate(rows):
                row.copy_(packed[i])
            events = ()
        return rows, packed, events

    def _upload_tensor(self, host: torch.Tensor) -> torch.Tensor:
        if not self._cuda:
            return host
        return host.pin_memory().to(self.device, non_blocking=True)

    def _upload(self, array: np.ndarray) -> torch.Tensor:
        return self._upload_tensor(torch.from_numpy(array))

    def _event(self):
        """A recorded CUDA timing event on the current stream (None on the
        CPU)."""
        if not self._cuda:
            return None
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        return event

    # -- public surface ---------------------------------------------------

    @property
    def params_step(self) -> int:
        """Checkpoint step of the current serving weights."""
        return self._live.step

    @property
    def registry(self) -> MetricsRegistry:
        return self._registry

    @property
    def failed(self) -> BaseException | None:
        """The terminal fault, once the engine tripped its failed state."""
        return self._failed

    def queue_depth(self) -> int:
        return self._q.qsize()

    @property
    def knobs(self) -> _LiveKnobs:
        """The live knob vector (the controller's read side)."""
        return self._knobs

    @property
    def latency_histogram(self) -> Histogram:
        """The end-to-end request-latency histogram, whose window deltas
        give ``serve_p99_ms`` and the controller's objective."""
        return self._h_e2e

    def set_knobs(self, *, batch_timeout_ms: float | None = None,
                  max_queue: int | None = None) -> _LiveKnobs:
        """Install new live knobs (the controller's actuator; also by hand),
        each clamped to its configured value as the ceiling; negative
        timeouts and queues under 1 are refused. The ingress bound follows
        ``max_queue`` at once (under the queue's mutex); the new vector is
        returned and published as the ``serve_knob_*`` gauges."""
        cur = self._knobs
        batch_timeout_ms = float(cur.batch_timeout_ms
                                 if batch_timeout_ms is None
                                 else batch_timeout_ms)
        max_queue = int(cur.max_queue if max_queue is None else max_queue)
        if batch_timeout_ms < 0:
            raise ConfigError(
                f"batch_timeout_ms must be >= 0, got {batch_timeout_ms}")
        if max_queue < 1:
            raise ConfigError(f"max_queue must be >= 1, got {max_queue}")
        new = _LiveKnobs(
            batch_timeout_ms=min(batch_timeout_ms, self.cfg.batch_timeout_ms),
            max_queue=min(max_queue, self.cfg.max_queue))
        self._knobs = new
        if new.max_queue != cur.max_queue:
            # put_nowait reads maxsize under this mutex: the next admission
            # sees the new bound. A shrink below the depth sheds or rejects
            # until the dispatcher drains under it.
            with self._q.mutex:
                self._q.maxsize = new.max_queue
                self._q.not_full.notify_all()
        self._registry.record_many({
            "serve_knob_batch_timeout_ms": new.batch_timeout_ms,
            "serve_knob_max_queue": float(new.max_queue)})
        return new

    def exemplars(self) -> list[dict]:
        """The slowest-request ring (the last windows' top-K and the window
        in progress), slowest first; safe from any thread."""
        with self._ex_lock:
            merged = list(self._exemplars) + list(self._window_slowest)
        return sorted(merged, key=lambda e: -e["latency_ms"])

    def refresh_spill_gauges(self) -> None:
        """Republish ``serve_spill_bytes`` / ``serve_spill_sessions`` from a
        fresh arena scan while no batch completes (the fleet front-end's
        ``/healthz`` calls it). The stats publish rides batch completions,
        so an idle engine's gauges would otherwise freeze exactly when a
        router sums them for a drain. At most one scan per
        ``serve.stats_interval_s``; safe from any thread."""
        arena = self._arena
        if arena is None:
            return
        now = time.perf_counter()
        if now - self._spill_scan_t < self.cfg.stats_interval_s:
            return
        self._spill_scan_t = now
        arena.scan_usage()
        self._registry.record_many({
            "serve_spill_bytes": float(arena.bytes),
            "serve_spill_sessions": float(arena.sessions)})

    def paging_ms(self) -> dict[str, float | None]:
        """Mean device ms per tick that paged: ``pageout`` (the park gather
        and its copy to the host) and ``install`` (upload and scatter); None
        where no tick paged or off the card."""
        return {k: (total / ticks if ticks else None)
                for k, (total, ticks) in self._paging_ms.items()}

    def submit(self, session_id: Any, obs: Any,
               callback: Callable[[ServeResult | None], None] | None = None,
               *, deadline_ms: float | None = None,
               session_clock: int | None = None) -> _Request:
        """Enqueue one query; thread-safe and never blocking. Returns a
        handle whose ``wait()`` blocks for the response; ``callback(result)``
        also fires (with None on failure). ``deadline_ms`` (None:
        ``serve.default_deadline_ms``; 0: none) bounds the wait before a
        batch. ``session_clock`` is the session's completed-response count,
        the stamp a spilled carry must carry to be adopted (None: only this
        engine incarnation's own records)."""
        if self._stop_event.is_set():
            raise RuntimeError("serve engine is stopped")
        if self._failed is not None:
            raise ServeEngineFailed(
                "serve engine is in the terminal failed state (last fault: "
                f"{self._failed!r}); rebuild it") from self._failed
        if deadline_ms is None:
            deadline_ms = self.cfg.default_deadline_ms
        req = _Request(session_id, np.asarray(obs, np.float32), callback,
                       deadline_ms=deadline_ms,
                       clock=(int(session_clock)
                              if session_clock is not None else None))
        with self._lock:
            self._pending += 1
            self.counters["requests"] += 1
        self._registry.inc("serve_requests_total")
        while True:
            try:
                self._q.put_nowait(req)
                if (self._stop_event.is_set()
                        and not self._dispatcher.is_alive()):
                    # stop() finished between the gate above and the put:
                    # nobody reads the queue again.
                    self._fail_leftovers()
                return req
            except queue.Full:
                pass
            with self._lock:
                self._overload_events += 1
            self._registry.record("serve_overload", 1.0)
            if self.cfg.shed_policy == "reject":
                self._registry.inc("serve_queue_rejected_total")
                with self._lock:
                    self.counters["rejected"] += 1
                self._finish_failed(req, ServeRejected(
                    f"ingress queue full ({self._knobs.max_queue}); request "
                    "rejected under shed_policy='reject'",
                    reason="queue_full"))
                return req
            # "oldest": shed the oldest queued request and retry the put
            # (the dispatcher may race us for it: then just retry).
            try:
                victim = self._q.get_nowait()
            except queue.Empty:
                continue
            self._registry.inc("serve_shed_total")
            self._finish_failed(victim, ServeRejected(
                "shed from the ingress queue under overload (shed_policy="
                f"'oldest', max_queue={self._knobs.max_queue})",
                reason="shed_oldest"))

    def swap_params(self, master_params: Any, step: int) -> None:
        """Install new serving weights between ticks. The compute copy is
        made and complete on the device before it is published, so the
        first tick that reads it reads finished weights; ticks in flight
        keep the old weights referenced until they are read back."""
        with torch.no_grad():
            params = self._precision.cast_compute(tree_map(
                lambda x: x.to(self.device), master_params))
        ready = self._event()
        if ready is not None:
            ready.synchronize()
        self._live = _Live(params, int(step))
        self._registry.inc("serve_swaps_total")
        log.info("serving params swapped to step %d", int(step))

    def warmup(self) -> None:
        """Run every program once on scratch rows (live slots untouched), so
        the first real request pays no kernel build or first launch. Must
        run before concurrent submits."""
        cfg = self.cfg
        obs = self._upload(np.full((cfg.max_batch, self.model.obs_dim), 10.0,
                                   np.float32))
        idx = self._upload(np.arange(cfg.slots, cfg.slots + cfg.max_batch,
                                     dtype=np.int64))
        params = self._live.params
        with torch.inference_mode():
            if self._generic:
                self._generic_program(params, obs, idx, self._upload(
                    np.ones((cfg.max_batch,), np.bool_)))
            else:
                self._cold_program(params, obs, idx)
                self._warm_program(params, obs, idx)
            if self._warm_enabled:
                # The page-out's device work alone: a queued page-out would
                # race the running dispatcher, which commits it into the
                # warm store as a session.
                self._copy_out([cfg.slots])
                self._install([self._park_gather([cfg.slots])[0].cpu()],
                              [cfg.slots])
        if self._cuda:
            torch.cuda.synchronize(self.device)

    def drain(self, timeout_s: float = 30.0) -> bool:
        """Block until every submitted request has been answered; False on
        timeout."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            with self._lock:
                if self._pending == 0:
                    return True
            time.sleep(0.002)
        with self._lock:
            return self._pending == 0

    def stop(self, *, drain: bool = True, timeout_s: float = 30.0) -> bool:
        """Drain (optionally) and stop both threads; False, and logged, when
        a thread is still alive after its join timeout."""
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
        ok = True
        for thread in (self._dispatcher, self._consumer):
            if thread.is_alive():
                log.error("serve %s thread still alive %.1fs after stop(): "
                          "shutdown is NOT clean", thread.name, timeout_s)
                ok = False
        self._publish_stats(force=True)
        return ok

    def page_out_all(self) -> dict[str, int]:
        """Seal every surviving carry (parked, hot, and in the inboxes) into
        the spill arena, so another engine adopts the sessions warm. Only
        after :meth:`stop`: the order is drain, stop, page_out_all, exit.
        Returns ``{"written", "refused", "skipped_takes"}``; all zero
        without a spill arena."""
        if self._dispatcher.is_alive() or self._consumer.is_alive():
            raise RuntimeError(
                "page_out_all() before stop(): the dispatcher/consumer "
                "threads still own the session stores — the drain ordering "
                "is drain -> stop() -> page_out_all() -> exit")
        counts = {"written": 0, "refused": 0, "skipped_takes": 0}
        arena = self._arena
        if arena is None:
            return counts
        # Page-outs first: their warm commits may demote into puts.
        self._commit_page_outs(wait=True)
        counts["skipped_takes"] = sum(
            1 for op in self._spill_ops if op[0] == "take")
        self._drain_spill_ops()

        def seal(sid: Any, row: torch.Tensor, steps: int) -> None:
            if arena.put(sid, [row.numpy()], steps):
                counts["written"] += 1
                self._registry.inc("serve_spill_puts_total")
            else:
                counts["refused"] += 1
                self._registry.inc("serve_spill_put_refusals_total")

        while self._spill_inbox:
            sid, rows, steps, _reason = self._spill_inbox.popleft()
            if rows is not None and not self._slots.contains(sid):
                seal(sid, rows, steps)
        for sid, (rows, _nbytes, steps) in list(self._warm._lru.items()):
            seal(sid, rows, steps)
        if len(self._slots):
            hot = list(self._slots._lru.items())
            packed = self._park_gather([slot for _, slot in hot]).cpu()
            for i, (sid, _slot) in enumerate(hot):
                seal(sid, packed[i], self._steps.get(sid, 0))
        log.info("drain page-out sealed %d carr%s to the spill arena (%d "
                 "refused, %d takes left for adopters)", counts["written"],
                 "y" if counts["written"] == 1 else "ies", counts["refused"],
                 counts["skipped_takes"])
        self._publish_stats(force=True)
        return counts

    # -- dispatcher thread ------------------------------------------------

    def _serve_loop(self) -> None:
        with torch.inference_mode():
            while not self._stop_event.is_set():
                if self._failed is not None:
                    self._drain_failed()
                    continue
                while self._poisoned:
                    sid = self._poisoned.popleft()
                    self._slots.drop(sid)
                    self._steps.pop(sid, None)
                if self._restart_requested.is_set():
                    self._restart_requested.clear()
                    if self._consumer_fault_epoch >= self._fault_epoch:
                        self._supervise(self._consumer_fault
                                        or RuntimeError("serve consumer "
                                                        "fault"))
                    continue
                batch = self._collect_batch()
                if not batch:
                    continue
                live = self._live       # ONE read per tick
                try:
                    done = self._dispatch_batch(batch, live)
                except Exception as exc:   # noqa: BLE001 — fail the batch,
                    # keep serving the sessions of later batches.
                    # Victims whose page-out never started restart cold.
                    self._parking.difference_update(self._tick_victims)
                    self._fail_batch(batch, exc)
                    self._supervise(exc)
                    continue
                self._done_q.put(done)
        self._fail_leftovers()

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

    def _fail_batch(self, batch: list[_Request], exc: Exception) -> None:
        log.exception("serve dispatch failed for a %d-request batch: %s",
                      len(batch), exc)
        for req in batch:
            # The admitted slot may never have received its carry.
            self._slots.drop(req.session_id)
            self._steps.pop(req.session_id, None)
            self._finish_failed(req, exc)

    def _finish_failed(self, req: _Request, exc: BaseException) -> None:
        """Complete a request with a terminal error (rejection, shed,
        expiry, a failed batch or engine), then publish: under an outage
        nothing completes, and the availability burn must climb during it.
        The publish skips when another thread holds it and does no disk
        I/O (this runs on submitters' threads and the dispatcher)."""
        with self._lock:
            self._pending -= 1
            self.counters["failed"] += 1
            self._term_total += 1
            self._term_bad += 1
        req.error = exc
        req.outcome = _outcome(exc)
        req._event.set()
        _fire(req.callback, None)
        self._publish_stats(io_ok=False)

    # -- supervision (serve.max_restarts > 0) ------------------------------

    def _supervise(self, exc: BaseException) -> None:
        """Rebuild the engine after a fault under seeded exponential
        backoff; more than ``max_restarts`` consecutive faults (reset by a
        completed batch dispatched after the latest fault) trip the terminal
        failed state. A failed rebuild is the next fault of the streak."""
        if self.cfg.max_restarts <= 0:
            return
        with self._sup_lock:
            self._fault_epoch += 1
        while not self._stop_event.is_set():
            with self._sup_lock:
                self._restart_streak += 1
                streak = self._restart_streak
            if streak > self.cfg.max_restarts:
                self._enter_failed(exc)
                return
            self._registry.inc("serve_restarts_total")
            self._backoff_sleep(streak)
            try:
                self._build_arena()
                self.warmup()
                log.warning("serve engine rebuilt after fault (restart "
                            "%d/%d): fresh slot arena, all sessions cold",
                            streak, self.cfg.max_restarts)
                return
            except Exception as rebuild_exc:    # noqa: BLE001
                log.exception("serve engine rebuild failed")
                exc = rebuild_exc

    def _backoff_sleep(self, attempt: int) -> None:
        """initial * 2^(attempt-1), capped, times seeded jitter in [0.5,
        1.5); waits on the stop event, so a stop never waits out a
        backoff."""
        cfg = self.cfg
        delay = min(cfg.restart_backoff_s * (2.0 ** (attempt - 1)),
                    cfg.restart_backoff_max_s)
        delay *= 0.5 + self._restart_rng.random()
        self._stop_event.wait(delay)

    def _enter_failed(self, exc: BaseException) -> None:
        self._failed = exc
        self._registry.record("serve_failed", 1.0)
        log.error("serve engine TERMINALLY FAILED: %d consecutive faults "
                  "exceeded serve.max_restarts=%d (last: %r); failing all "
                  "queued work", self._restart_streak, self.cfg.max_restarts,
                  exc)
        self._drain_failed()

    def _drain_failed(self) -> None:
        """Fail everything queued or deferred with ServeEngineFailed (a
        bounded wait on the empty queue keeps the loop responsive to
        stop)."""
        failure = ServeEngineFailed(
            f"serve engine is terminally failed (last fault: "
            f"{self._failed!r})")
        failure.__cause__ = self._failed
        while self._deferred:
            self._finish_failed(self._deferred.popleft(), failure)
        try:
            while True:
                self._finish_failed(self._q.get(timeout=0.05), failure)
        except queue.Empty:
            pass

    # -- batch collection -------------------------------------------------

    def _expire_if_dead(self, req: _Request, now: float) -> bool:
        """Complete an expired request with ServeDeadlineExceeded before it
        takes a row; True when it was expired."""
        if req.t_deadline is None or now < req.t_deadline:
            return False
        self._registry.inc("serve_deadline_expired_total")
        self._finish_failed(req, ServeDeadlineExceeded(
            f"deadline expired {1e3 * (now - req.t_deadline):.1f} ms ago "
            "before the request reached a batch"))
        return True

    def _collect_batch(self) -> list[_Request]:
        """Deferred same-session requests first, then the queue until
        ``max_batch`` or the coalescing deadline (anchored at the first
        request and clamped to the earliest surviving request's deadline),
        then whatever is already queued, without waiting.
        Expired requests complete with a deadline error and never join.
        The live knobs are read once for the tick."""
        cfg = self.cfg
        knobs = self._knobs
        # Parked rows first, then adopted disk takes (which must land in
        # the warm store freshest, so a park commit cannot demote them).
        self._commit_page_outs()
        self._drain_spill_inbox()
        batch: list[_Request] = []
        seen: set = set()
        kept: deque[_Request] = deque()
        now = time.perf_counter()
        while self._deferred:
            req = self._deferred.popleft()
            if self._expire_if_dead(req, now):
                continue
            if (req.session_id in seen or len(batch) >= cfg.max_batch
                    or self._in_transit(req)):
                req.deferrals += 1
                kept.append(req)
            else:
                req.t_collected = now
                batch.append(req)
                seen.add(req.session_id)
        self._deferred = kept
        if not batch:
            # Poll briefly while a disk take is in flight: the consumer
            # resolves it in microseconds.
            timeout = (0.001 if self._parking or self._spill_inflight
                       or self._spill_putting else 0.05)
            try:
                req = self._q.get(timeout=timeout)
            except queue.Empty:
                return []
            if self._expire_if_dead(req, time.perf_counter()):
                return []
            if self._in_transit(req):
                req.deferrals += 1
                self._deferred.append(req)
                return []
            req.t_collected = time.perf_counter()
            batch.append(req)
            seen.add(req.session_id)
        deadline = time.perf_counter() + knobs.batch_timeout_ms / 1e3
        for req in batch:           # anchor to the earliest survivor
            if req.t_deadline is not None:
                deadline = min(deadline, req.t_deadline)
        while len(batch) < cfg.max_batch:
            remaining = deadline - time.perf_counter()
            try:
                # Past the coalescing deadline, requests already queued
                # still join without waiting: at batch_timeout_ms=0 (the
                # controller's floor) a backlog is served in full batches,
                # not one request a tick as the JAX engine does.
                req = (self._q.get(timeout=remaining) if remaining > 0
                       else self._q.get_nowait())
            except queue.Empty:
                break
            if self._expire_if_dead(req, time.perf_counter()):
                continue
            if req.session_id in seen:
                if len(self._deferred) >= knobs.max_queue:
                    # The same-session backlog is bounded too.
                    with self._lock:
                        self._overload_events += 1
                    self._registry.record("serve_overload", 1.0)
                    if cfg.shed_policy == "oldest":
                        self._registry.inc("serve_shed_total")
                        self._finish_failed(
                            self._deferred.popleft(), ServeRejected(
                                "shed from the same-session backlog under "
                                "overload (shed_policy='oldest')",
                                reason="shed_oldest"))
                        req.deferrals += 1
                        self._deferred.append(req)
                    else:
                        self._registry.inc("serve_queue_rejected_total")
                        with self._lock:
                            self.counters["rejected"] += 1
                        self._finish_failed(req, ServeRejected(
                            "same-session backlog exceeded serve.max_queue",
                            reason="deferred_overflow"))
                    continue
                req.deferrals += 1
                self._deferred.append(req)
                continue
            if self._in_transit(req):
                req.deferrals += 1
                self._deferred.append(req)
                continue
            req.t_collected = time.perf_counter()
            batch.append(req)
            seen.add(req.session_id)
            if req.t_deadline is not None and req.t_deadline < deadline:
                deadline = req.t_deadline
        return batch

    def _dispatch_batch(self, batch: list[_Request], live: _Live
                        ) -> _DoneBatch:
        """Admit (hot, warm or cold), page out the tick's eviction victims,
        install the warm hits' carries, and enqueue the tick's program(s),
        all under the weights ``live`` read once for the tick."""
        pinned = {r.session_id for r in batch}
        # Readbacks that completed during the collection wait: a session
        # evicted last tick must find its parked carry at admission.
        rescued = self._commit_page_outs(pinned=pinned)
        cold_reqs, cold_idx, warm_reqs, warm_idx = [], [], [], []
        evicted = 0
        # The tick's eviction victims, kept where a failed dispatch can
        # release their deferred requests (no page-out will come).
        park_sids = self._tick_victims = []
        park_slots, park_steps = [], []
        unpark_slots, unpark_rows = [], []
        warm_on = self._warm_enabled
        reg = self._registry
        for req in batch:
            sid = req.session_id
            slot = self._slots.lookup(sid)
            if slot is not None:
                if warm_on:
                    self._steps[sid] = self._steps.get(sid, 0) + 1
                warm_reqs.append(req)
                warm_idx.append(slot)
                continue
            parked = rescued.pop(sid, None) if warm_on else None
            if parked is None and warm_on:
                parked = self._warm.pop(sid)
            if (parked is not None and req.clock is not None
                    and parked[1] != req.clock):
                # A parked carry from an earlier stint the session's clock
                # has outrun: serving it would change the answer.
                self._warm.stale_drops += 1
                reg.inc("serve_warm_stale_drops_total")
                parked = None
            slot, victim = self._slots.admit(sid, pinned)
            if victim is not None:
                evicted += 1
                if warm_on:
                    park_sids.append(victim)
                    park_slots.append(slot)
                    park_steps.append(self._steps.pop(victim, 0))
                    self._parking.add(victim)
            if parked is not None:
                rows, psteps = parked
                reg.inc("serve_warm_hits_total")
                self._steps[sid] = psteps + 1
                unpark_slots.append(slot)
                unpark_rows.append(rows)
                warm_reqs.append(req)
                warm_idx.append(slot)
            else:
                if warm_on:
                    reg.inc("serve_warm_misses_total")
                    self._steps[sid] = (req.clock + 1
                                        if req.clock is not None else 1)
                    if req.clock:
                        reg.inc("serve_adopt_cold_total")
                    if self._spill_enabled:
                        # A cold (re)start invalidates any record the arena
                        # still holds for this session.
                        self._spill_ops.append(("del", sid))
                        self._kick_consumer()
                cold_reqs.append(req)
                cold_idx.append(slot)
        for sid, (rows, psteps) in rescued.items():
            self._commit_warm(sid, rows, psteps)
        # The victims' rows are gathered before the install and the
        # programs write their slots (one stream orders them).
        install_events = None
        if park_sids:
            self._start_page_out(park_sids, park_steps, park_slots)
        self._tick_victims = []
        if unpark_rows:
            start = self._event()
            self._install(unpark_rows, unpark_slots)
            if start is not None:
                install_events = (start, self._event())
        self._batch_serial += 1
        params = live.params
        groups = []
        if self._generic:
            reqs = cold_reqs + warm_reqs
            obs, pidx = self._pad(reqs, cold_idx + warm_idx)
            cold = np.zeros((self.cfg.max_batch,), np.bool_)
            cold[:len(cold_reqs)] = True
            self._stamp(reqs, self._batch_serial, False)
            for req in cold_reqs:
                req.cold = True
            act, logits, values = self._generic_program(
                params, self._upload(obs), self._upload(pidx),
                self._upload(cold))
            groups.append((reqs, act, logits, values))
            with self._lock:
                self.counters["generic_batches"] += 1
        else:
            for reqs, idx, program, key in (
                    (cold_reqs, cold_idx, self._cold_program, "cold"),
                    (warm_reqs, warm_idx, self._warm_program, "warm")):
                if not reqs:
                    continue
                obs, pidx = self._pad(reqs, idx)
                self._stamp(reqs, self._batch_serial, key == "cold")
                act, logits, values = program(params, self._upload(obs),
                                              self._upload(pidx))
                groups.append((reqs, act, logits, values))
                with self._lock:
                    self.counters[f"{key}_batches"] += 1
        with self._lock:
            self.counters["batches"] += 1
            self.counters["cold_rows"] += len(cold_reqs)
            self.counters["warm_rows"] += len(warm_reqs)
            self.counters["evictions"] += evicted
        return _DoneBatch(groups=groups, live=live, n=len(batch),
                          serial=self._batch_serial, cold=len(cold_reqs),
                          evicted=evicted, epoch=self._fault_epoch,
                          install_events=install_events,
                          installed=tuple(unpark_rows))

    @staticmethod
    def _stamp(reqs: list[_Request], serial: int, cold: bool) -> None:
        """The dispatch edge: the program is enqueued right after, so the
        device stage holds its device work and the queue ahead of it."""
        t = time.perf_counter()
        for req in reqs:
            req.t_dispatched = t
            req.batch = serial
            req.cold = cold

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

    # -- session paging (dispatch side) -----------------------------------

    def _commit_page_outs(self, pinned: set | None = None, *,
                          wait: bool = False) -> dict[Any, tuple[Any, int]]:
        """Commit the page-outs whose copies have ended (all of them, waited
        for, with ``wait``) into the warm store, in stream order. A commit
        that would demote a carry whose session is in this tick's batch
        (``pinned``) hands it back in the returned dict instead, for
        admission to consume. A failed copy releases its sessions cold."""
        rescued: dict[Any, tuple[Any, int]] = {}
        while self._pageouts:
            out = self._pageouts[0]
            try:
                if out.events and not (wait or out.events[3].query()):
                    break
                if out.events:
                    out.events[3].synchronize()
                    self._paging_ms["pageout"][0] += (
                        out.events[0].elapsed_time(out.events[1])
                        + out.events[2].elapsed_time(out.events[3]))
                    self._paging_ms["pageout"][1] += 1
            except Exception:   # noqa: BLE001 — the device failed under
                # the copy: the sessions restart cold; the next dispatch
                # meets the fault.
                log.exception("serve page-out failed")
                self._pageouts.popleft()
                self._parking.difference_update(out.sids)
                continue
            self._pageouts.popleft()
            self._registry.inc("serve_warm_parks_total", len(out.sids))
            for sid, row, steps in zip(out.sids, out.rows, out.steps):
                self._parking.discard(sid)
                if self._slots.contains(sid):
                    self._warm.stale_drops += 1
                    self._registry.inc("serve_warm_stale_drops_total")
                    continue
                self._commit_warm(sid, row, steps, pinned=pinned,
                                  rescued=rescued)
        return rescued

    def _commit_warm(self, sid: Any, rows: Any, steps: int, *,
                     pinned: set | None = None,
                     rescued: dict | None = None) -> None:
        """Park one host carry; the overflow goes to the spill arena (tier
        on) or cold, but for this tick's pinned sessions."""
        demoted = self._warm.put(sid, rows, self._carry_nbytes, steps)
        if demoted and pinned and rescued is not None:
            kept = []
            for victim, vrows, vnbytes, vsteps in demoted:
                if victim in pinned:
                    rescued[victim] = (vrows, vsteps)
                    self._warm.demotions -= 1
                else:
                    kept.append((victim, vrows, vnbytes, vsteps))
            demoted = kept
        if demoted:
            self._registry.inc("serve_warm_demotions_total", len(demoted))
            if self._spill_enabled:
                for victim, vrows, _vnbytes, vsteps in demoted:
                    self._spill_ops.append(("put", victim, vrows, vsteps))
                    self._spill_putting[victim] = (
                        self._spill_putting.get(victim, 0) + 1)
                self._kick_consumer()

    def _kick_consumer(self) -> None:
        try:
            self._done_q.put_nowait(_SPILL_TICK)
        except queue.Full:
            pass                # the consumer is awake and drains the ops

    def _drain_spill_inbox(self) -> None:
        """Commit completed disk takes into the warm store and release
        their sessions' deferred requests."""
        while self._spill_put_done:
            sid = self._spill_put_done.popleft()
            left = self._spill_putting.pop(sid, 1) - 1
            if left > 0:
                self._spill_putting[sid] = left
        while self._spill_inbox:
            sid, rows, steps, _reason = self._spill_inbox.popleft()
            self._spill_inflight.discard(sid)
            if rows is None:
                continue        # miss, stale or corrupt: the session is cold
            if self._slots.contains(sid):
                self._warm.stale_drops += 1
                self._registry.inc("serve_warm_stale_drops_total")
                continue
            self._commit_warm(sid, rows, steps)

    def _in_transit(self, req: _Request) -> bool:
        """True when the request must defer because its session's carry is
        in transit: a page-out not yet committed, a put to disk not yet
        sealed, or a disk take (one in flight, or the one begun here when
        the arena holds a record). Only an ``os.stat`` runs on this
        thread."""
        if req.session_id in self._parking:
            return True
        if not self._spill_enabled:
            return False
        sid = req.session_id
        if sid in self._spill_inflight:
            return True
        if self._slots.contains(sid) or self._warm.contains(sid):
            return False
        if sid in self._spill_putting:
            return True         # its carry is on its way to disk
        if not self._arena.probe(sid):
            return False
        self._spill_ops.append(("take", sid, req.clock))
        self._spill_inflight.add(sid)
        self._kick_consumer()
        return True

    # -- consumer thread --------------------------------------------------

    def _complete_loop(self) -> None:
        while True:
            try:
                item = self._done_q.get(timeout=0.2)
            except queue.Empty:
                if (self._stop_event.is_set()
                        and not self._dispatcher.is_alive()):
                    while True:
                        try:
                            item = self._done_q.get_nowait()
                        except queue.Empty:
                            self._drain_spill_ops()
                            return
                        if item is not _SHUTDOWN and item is not _SPILL_TICK:
                            self._consume_done(item)
                continue
            if item is _SHUTDOWN:
                self._drain_spill_ops()
                return
            if item is not _SPILL_TICK:
                self._consume_done(item)
            self._drain_spill_ops()

    def _consume_done(self, done: _DoneBatch) -> None:
        try:
            self._complete_batch(done)
        except Exception as exc:  # noqa: BLE001 — a readback fault fails
            # the batch's remaining requests instead of stranding them.
            log.exception("serve consumer failed completing a batch")
            for reqs, *_ in done.groups:
                for req in reqs:
                    # The program advanced these sessions' carries; the
                    # dispatcher drops them so a retry does not step twice.
                    self._poisoned.append(req.session_id)
                    if not req._event.is_set():
                        req.error = exc
                        req.outcome = "failed"
                        with self._lock:
                            # Pending fell with the batch; only the SLO
                            # accounting is per request here.
                            self._term_total += 1
                            self._term_bad += 1
                        req._event.set()
                        _fire(req.callback, None)
            self._consumer_fault = exc
            self._consumer_fault_epoch = done.epoch
            self._restart_requested.set()

    _SPILL_REASON_COUNTERS = {
        "hit": "serve_spill_hits_total",
        "miss": "serve_spill_misses_total",
        "stale": "serve_spill_stale_total",
        "corrupt": "serve_spill_corrupt_total",
    }

    def _drain_spill_ops(self) -> None:
        """Run the queued arena ops: the only spill disk I/O while the
        engine runs. After stop, takes are skipped (the records stay for
        whichever engine adopts the sessions next)."""
        arena = self._arena
        if arena is None:
            return
        skip_takes = self._stop_event.is_set()
        while self._spill_ops:
            op = self._spill_ops.popleft()
            try:
                self._run_spill_op(arena, op, skip_takes)
            except Exception:   # noqa: BLE001 — an op that fails costs its
                # session a cold restart, never the consumer thread.
                log.exception("spill %s failed for session %r", op[0],
                              op[1])
                if op[0] == "take":
                    self._spill_inbox.append((op[1], None, 0, "error"))
            if op[0] == "put":
                self._spill_put_done.append(op[1])

    def _run_spill_op(self, arena: SpillArena, op: tuple,
                      skip_takes: bool) -> None:
        reg = self._registry
        kind = op[0]
        if kind == "put":
            _, sid, rows, steps = op
            ok = arena.put(sid, [rows.numpy()], steps)
            reg.inc("serve_spill_puts_total" if ok
                    else "serve_spill_put_refusals_total")
        elif kind == "del":
            arena.delete(op[1])
        elif skip_takes:
            self._spill_inbox.append((op[1], None, 0, "skipped"))
        else:
            _, sid, clock = op
            payload, steps, reason, foreign = arena.take(sid, clock)
            reg.inc(self._SPILL_REASON_COUNTERS[reason])
            if reason == "hit" and clock is not None and foreign:
                # A clocked hit on another incarnation's record: a warm
                # adoption across engines.
                reg.inc("serve_adopt_warm_total")
            rows = (self._rows_from_payload(payload)
                    if payload is not None else None)
            self._spill_inbox.append((sid, rows, steps, reason))

    def _rows_from_payload(self, payload: bytes) -> torch.Tensor:
        """A record's payload as a parked carry: a flat host byte row
        (pinned on the card), the layout ``_park_gather`` packs (the arena
        already checked its length)."""
        row = torch.empty(len(payload), dtype=torch.uint8,
                          pin_memory=self._cuda)
        row.copy_(torch.frombuffer(bytearray(payload), dtype=torch.uint8))
        return row

    def _complete_batch(self, done: _DoneBatch) -> None:
        """Readback + completion; blocking host work belongs here. Each
        completed request is observed into the stage histograms and checked
        against the stage decomposition; the tick then publishes."""
        n_done = slow = 0
        hists = self._hists
        slo_target = self._slo[1]
        try:
            for reqs, act_dev, logit_dev, val_dev in done.groups:
                actions = act_dev.cpu().numpy()
                logits = logit_dev.cpu().numpy()
                values = val_dev.cpu().numpy()
                now = time.perf_counter()
                # The consumer completes a batch's requests one after the
                # other: the readback histogram bills each only its own
                # completion slice.
                t_prev = now
                for i, req in enumerate(reqs):
                    req.t_device = now
                    t_coll = req.t_collected or req.t_enq
                    t_disp = req.t_dispatched or t_coll
                    latency_ms = (now - req.t_enq) * 1e3
                    stages = {"queue_wait_ms": (t_coll - req.t_enq) * 1e3,
                              "batch_wait_ms": (t_disp - t_coll) * 1e3,
                              "device_ms": (now - t_disp) * 1e3}
                    if req.cold:
                        # What a cold re-entry costs (device ms with its
                        # queueing): the warm tier's economics gauge.
                        prev = self._ewma_prefill_ms
                        self._ewma_prefill_ms = (
                            stages["device_ms"] if prev == 0.0
                            else 0.9 * prev + 0.1 * stages["device_ms"])
                    result = ServeResult(
                        session_id=req.session_id, action=int(actions[i]),
                        logits=logits[i], value=float(values[i]),
                        params_step=done.live.step, latency_ms=latency_ms,
                        stages=stages, batch=done.serial)
                    req.result = result
                    req.outcome = "completed"
                    req._event.set()
                    n_done += 1
                    _fire(req.callback, result)
                    req.t_done = time.perf_counter()
                    hists["serve_queue_wait_ms"].observe(
                        stages["queue_wait_ms"])
                    hists["serve_batch_wait_ms"].observe(
                        stages["batch_wait_ms"])
                    hists["serve_device_ms"].observe(stages["device_ms"])
                    hists["serve_readback_ms"].observe(
                        (req.t_done - t_prev) * 1e3)
                    t_prev = req.t_done
                    self._h_e2e.observe(latency_ms)
                    if abs(sum(stages.values()) - latency_ms) > 1e-6:
                        # Exact by construction: drift means a stamp broke.
                        self._registry.inc(
                            "serve_trace_decomposition_error_total")
                    if slo_target and latency_ms > slo_target:
                        slow += 1
                    if self._exemplar_k:
                        self._note_exemplar(req, latency_ms, stages,
                                            done.live.step)
            if done.install_events is not None:
                start, end = done.install_events
                end.synchronize()
                self._paging_ms["install"][0] += start.elapsed_time(end)
                self._paging_ms["install"][1] += 1
        finally:
            with self._lock:
                self._pending -= done.n
                self.counters["completed"] += n_done
                self.counters["failed"] += done.n - n_done
                self._term_total += n_done
                self._term_completed += n_done
                self._term_slow += slow
        # A completed batch dispatched after the latest fault heals the
        # consecutive-fault streak.
        with self._sup_lock:
            if done.epoch == self._fault_epoch:
                self._restart_streak = 0
        with self._lock:
            self._stats_completed += done.n
            self._stats_occupancy += done.n / self.cfg.max_batch
            self._stats_ticks += 1
        reg = self._registry
        reg.inc("serve_responses_total", done.n)
        reg.inc("serve_batches_total")
        if done.cold:
            reg.inc("serve_prefills_total", done.cold)
        if done.evicted:
            reg.inc("serve_evictions_total", done.evicted)
        self._publish_stats()

    # -- telemetry ----------------------------------------------------------

    def _note_exemplar(self, req: _Request, latency_ms: float,
                       stages: dict, step: int) -> None:
        """Keep the window's ``exemplar_k`` slowest completed requests with
        their stage split (consumer thread; K is small)."""
        with self._ex_lock:
            w = self._window_slowest
            if len(w) >= self._exemplar_k:
                m = min(range(len(w)), key=lambda j: w[j]["latency_ms"])
                if latency_ms <= w[m]["latency_ms"]:
                    return
                del w[m]
            w.append({
                "session": str(req.session_id),
                "latency_ms": round(latency_ms, 3),
                "stages": {k: round(v, 3) for k, v in stages.items()},
                "batch": req.batch,
                "cold": req.cold,
                "deferrals": req.deferrals,
                "params_step": step,
            })

    def _publish_stats(self, *, force: bool = False,
                       io_ok: bool = True) -> None:
        """The gauges at ``serve.stats_interval_s``: from the consumer after
        every batch, from failure paths on any thread (``io_ok=False``: no
        disk I/O there), and from ``stop`` / ``page_out_all`` (``force``).
        A caller that is not forced skips when another thread publishes."""
        now = time.perf_counter()
        if not force and now - self._stats_t < self.cfg.stats_interval_s:
            return
        if not self._stats_lock.acquire(blocking=force):
            return
        try:
            if force:
                # Past any publish that won the lock while this one waited.
                now = time.perf_counter()
            self._publish_stats_locked(now, force, io_ok)
        finally:
            self._stats_lock.release()

    def _publish_stats_locked(self, now: float, force: bool,
                              io_ok: bool) -> None:
        interval = now - self._stats_t
        if (not force and interval < self.cfg.stats_interval_s
                or interval <= 0):
            return
        with self._lock:
            overload_events = self._overload_events
            self._overload_events = 0
            term = (self._term_total, self._term_bad,
                    self._term_completed, self._term_slow)
            completed = self._stats_completed
            occupancy, ticks = self._stats_occupancy, self._stats_ticks
            self._stats_completed = 0
            self._stats_occupancy, self._stats_ticks = 0.0, 0
        depth = self._q.qsize()
        overloaded = overload_events > 0 or depth >= self._knobs.max_queue
        row: dict[str, float] = {
            "serve_qps": completed / interval,
            "serve_queue_depth": float(depth),
            # 1 while the engine sheds or rejects or the queue is pinned.
            "serve_overload": float(overloaded),
        }
        # p50/p99 of the window: the end-to-end histogram's bucket delta.
        snap = self._h_e2e.snapshot()
        delta = [a - b for a, b in zip(snap["counts"],
                                       self._p50_prev_counts)]
        self._p50_prev_counts = snap["counts"]
        if sum(delta) > 0:
            row["serve_p50_ms"] = self._h_e2e.quantile(0.50, counts=delta)
            row["serve_p99_ms"] = self._h_e2e.quantile(0.99, counts=delta)
        if ticks:
            row["serve_batch_occupancy"] = occupancy / ticks
        # Dispatcher-owned sizes read as gauges (a tick stale at worst).
        row["serve_sessions_hot"] = float(len(self._slots))
        if self._warm_enabled:
            warm = self._warm
            row["serve_warm_sessions"] = float(len(warm))
            row["serve_warm_bytes"] = float(warm.bytes)
            row["serve_warm_budget_bytes"] = float(warm.max_bytes)
            # Prefill ms this window's warm hits avoided, per MB held.
            hits = self._registry.counters().get("serve_warm_hits_total",
                                                 0.0)
            d_hits = max(0.0, hits - self._prev_warm_hits)
            self._prev_warm_hits = hits
            held_mb = warm.bytes / 2**20
            row["serve_warm_econ_ms_per_mb"] = (
                d_hits * self._ewma_prefill_ms / held_mb
                if held_mb > 0 else 0.0)
        arena = self._arena
        if arena is not None:
            if io_ok:
                arena.scan_usage()      # one bounded scandir, consumer only
                self._spill_scan_t = now
            row["serve_spill_bytes"] = float(arena.bytes)
            row["serve_spill_sessions"] = float(arena.sessions)
            row["serve_spill_budget_bytes"] = float(arena.max_bytes)
        row.update(self._slo_burn(now, term))
        self._registry.record_many(row)
        self._fold_exemplars()
        self._stats_t = now

    def _slo_burn(self, now: float, term: tuple) -> dict[str, float]:
        """Burn rates over ``obs.slo_window_s``: the difference of the
        terminal-outcome totals between now and the newest publish at or
        before the window's edge (publishes sparser than the window leave
        one interval). Burn 1.0 spends exactly the error budget; crossing
        ``obs.slo_burn_threshold`` counts an alert, re-armed once the burn
        is under half of it."""
        if not self._slo_on:
            return {}
        avail, target_p99, window_s, threshold = self._slo
        win = self._slo_win
        win.append((now, *term))
        while len(win) > 1 and win[1][0] <= now - window_s:
            win.popleft()
        base = win[0]
        d_total, d_bad = term[0] - base[1], term[1] - base[2]
        d_completed, d_slow = term[2] - base[3], term[3] - base[4]
        out: dict[str, float] = {}
        burns: dict[str, float] = {}
        if avail > 0 and d_total > 0:
            burns["availability"] = (d_bad / d_total) / (1.0 - avail)
            out["serve_slo_availability_burn"] = burns["availability"]
        if target_p99 > 0 and d_completed > 0:
            burns["latency"] = (d_slow / d_completed) / 0.01
            out["serve_slo_latency_burn"] = burns["latency"]
        worst = max(burns.values(), default=0.0)
        if worst >= threshold and not self._burn_alarm:
            self._burn_alarm = True
            self._registry.inc("serve_slo_burn_alerts_total")
            log.warning("SLO burn rate %.2f crossed threshold %.2f (window "
                        "%ds: %d/%d bad, %d/%d slow)", worst, threshold,
                        int(window_s), d_bad, d_total, d_slow, d_completed)
        elif self._burn_alarm and worst < 0.5 * threshold:
            self._burn_alarm = False
        return out

    def _fold_exemplars(self) -> None:
        """End of a window: its slowest requests join the bounded ring."""
        with self._ex_lock:
            if self._window_slowest:
                self._exemplars.extend(sorted(
                    self._window_slowest, key=lambda e: -e["latency_ms"]))
                self._window_slowest = []
