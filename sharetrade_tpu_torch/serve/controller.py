"""Online serve controller: the engine's telemetry closed into its knobs.

The port's counterpart of the JAX package's ``serve/controller.py``, step
for step. The engine measures what an operator would tune
``batch_timeout_ms`` / ``max_queue`` from: the windowed end-to-end latency
histogram behind ``serve_p99_ms``, the shed / reject / expiry counters and
the queue depth. This module is the actuator: a feedback loop that holds a
target request p99 under whatever the arrival rate does, by moving the
same two knobs a human would:

- **objective**: the p99 of the engine's end-to-end latency histogram
  over the controller's own window (snapshot deltas: cumulative bucket
  counts subtract exactly, the ``serve_p99_ms`` math);
- **dead band + hysteresis**: above ``target_p99_ms`` the controller
  TIGHTENS; below ``rearm_frac * target`` it RELAXES back toward the
  configured values; in between it holds, so a noisy p99 hovering near
  the target does not flap the knobs;
- **bounded, rate-limited steps**: one multiplicative factor per tick
  (``shrink`` / ``grow``), at most ONE adjustment per ``interval_s``;
- **config is the ceiling**: :meth:`ServeEngine.set_knobs` clamps both
  knobs to their configured values, so the controller can only tighten
  below what the operator allowed and restore it. It never touches the
  shed policy, deadlines, supervision or the swap breaker.

Every adjustment is visible: the knob gauges (``serve_knob_*``), the
``serve_controller_adjustments_total`` counter, the
``serve_controller_p99_ms`` objective gauge, a log line, and a
flight-ring event per adjustment when obs is attached.

Deterministic by construction: :meth:`step` takes an optional fake ``now``
and :meth:`_decide` is a pure function of (p99, overload, knobs), so the
state machine runs on a fake clock with synthetic objective series: no
engine, no threads, no sleeps. The controller is host code: it reads the
engine's histogram and counters and calls ``set_knobs``, whatever device
the engine serves on.
"""

from __future__ import annotations

import threading
import time
from typing import Any, NamedTuple

from sharetrade_tpu_torch.config import ConfigError
from sharetrade_tpu_torch.utils.logging import get_logger

log = get_logger("serve.controller")

#: Counters whose deltas mean "the engine refused/expired work this
#: window" — the overload signal published next to the objective gauge.
_BAD_COUNTERS = ("serve_shed_total", "serve_queue_rejected_total",
                 "serve_deadline_expired_total")

#: Snap-to-floor threshold for the multiplicative timeout shrink (ms): a
#: geometric decay never REACHES the floor, and sub-50 µs coalescing
#: waits are indistinguishable from 0 on a host scheduler.
_TIMEOUT_SNAP_MS = 0.05

#: Additive escape for growing a timeout back off the 0 floor (ms):
#: multiplicative growth of 0 is 0 forever.
_TIMEOUT_GROW_FLOOR_MS = 0.25


class Adjustment(NamedTuple):
    """One applied knob change (the :meth:`ServeController.step` return
    value and the flight-ring payload)."""

    action: str                 # "tighten" | "relax"
    p99_ms: float
    batch_timeout_ms: float
    max_queue: int


class ServeController:
    """See the module docstring. Duck-typed against the engine surface
    (``cfg`` / ``knobs`` / ``set_knobs`` / ``registry`` /
    ``queue_depth`` / ``latency_histogram``), so tests drive it with a
    stub engine and a fake clock."""

    def __init__(self, engine: Any, *, target_p99_ms: float,
                 interval_s: float = 1.0, shrink: float = 0.5,
                 grow: float = 1.25, rearm_frac: float = 0.5,
                 min_batch_timeout_ms: float = 0.0,
                 min_queue: int | None = None, obs: Any = None,
                 clock=time.perf_counter):
        if target_p99_ms <= 0:
            raise ConfigError(
                f"tuning.target_p99_ms must be > 0, got {target_p99_ms}")
        if interval_s <= 0:
            raise ConfigError(
                f"tuning.controller_interval_s must be > 0, got "
                f"{interval_s}")
        if not 0.0 < shrink < 1.0 or grow <= 1.0:
            raise ConfigError(
                f"controller steps need 0 < shrink < 1 < grow, got "
                f"shrink={shrink} grow={grow}")
        if not 0.0 < rearm_frac < 1.0:
            raise ConfigError(
                f"controller rearm_frac must be in (0, 1), got "
                f"{rearm_frac}")
        self.engine = engine
        self.target_p99_ms = float(target_p99_ms)
        self.interval_s = float(interval_s)
        self._shrink = float(shrink)
        self._grow = float(grow)
        self._rearm_frac = float(rearm_frac)
        cfg = engine.cfg
        # Config values are the CEILINGS (set_knobs re-clamps anyway;
        # kept here so _decide is pure and the tests see the same bounds).
        self._ceil_timeout = float(cfg.batch_timeout_ms)
        self._ceil_queue = int(cfg.max_queue)
        self._min_timeout = max(0.0, float(min_batch_timeout_ms))
        # Queue floor: at least one full batch — admission below the
        # batch size starves occupancy without improving the tail.
        floor = int(min_queue) if min_queue else max(int(cfg.max_batch), 1)
        self._min_queue = max(1, min(floor, self._ceil_queue))
        self._obs = obs
        self._clock = clock
        self._hist = engine.latency_histogram
        self._prev_counts = self._hist.snapshot()["counts"]
        self._prev_bad = self._bad_total()
        self._last = clock()
        self.adjustments = 0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        engine.registry.record("serve_controller_target_p99_ms",
                               self.target_p99_ms)

    # -- thread plumbing --------------------------------------------------

    def start(self) -> "ServeController":
        """Run :meth:`step` every ``interval_s`` on a daemon thread (the
        wait rides the stop event: no sleeps)."""
        self._thread = threading.Thread(target=self._loop,
                                        name="serve-controller",
                                        daemon=True)
        self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.step()
            except Exception:   # noqa: BLE001 — a controller fault must
                # degrade to "knobs stop adapting", never kill serving.
                log.exception("serve controller step failed; holding "
                              "current knobs")

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(5.0)

    # -- the control loop -------------------------------------------------

    def _bad_total(self) -> float:
        counters = self.engine.registry.counters()
        return sum(counters.get(name, 0.0) for name in _BAD_COUNTERS)

    def window_p99(self) -> tuple[float | None, int]:
        """(p99 of the completions since the last call, count) — None
        when nothing completed in the window (no signal: hold)."""
        snap = self._hist.snapshot()
        delta = [a - b for a, b in zip(snap["counts"], self._prev_counts)]
        self._prev_counts = snap["counts"]
        completed = sum(delta)
        if completed <= 0:
            return None, 0
        return self._hist.quantile(0.99, counts=delta), completed

    def _decide(self, p99_ms: float | None, overloaded: bool, knobs: Any
                ) -> tuple[str, float, int] | None:
        """The pure state machine: (action, new_timeout, new_queue) or
        None (hold). Dead band [rearm_frac*target, target] = no action;
        both directions take ONE bounded multiplicative step, clamped to
        [floors, configured ceilings]. ``overloaded`` (any shed/reject/
        expiry in the window, or a pinned queue) VETOES relaxing: with
        tight admission, a low p99 is the tight knobs' doing, and
        relaxing while still shedding re-inflates the tail — the
        oscillation this veto exists to prevent (pinned by the
        no-oscillation test)."""
        if p99_ms is None:
            return None
        cur_t, cur_q = knobs.batch_timeout_ms, knobs.max_queue
        if p99_ms > self.target_p99_ms:
            # Over budget: cut the coalescing wait (the direct latency
            # lever) and the admission bound (queueing delay ~ depth /
            # service rate) together, one bounded step each.
            new_t = max(self._min_timeout, cur_t * self._shrink)
            if new_t < _TIMEOUT_SNAP_MS:
                new_t = self._min_timeout
            new_q = max(self._min_queue, int(cur_q * self._shrink))
            if new_t != cur_t or new_q != cur_q:
                return ("tighten", new_t, new_q)
            return None             # already at the floors: shed is the
            # remaining relief valve (admission control's territory)
        if (not overloaded
                and p99_ms < self._rearm_frac * self.target_p99_ms):
            # Clearly under budget (the hysteresis re-arm threshold) AND
            # a shed-free window: give back what was taken — toward the
            # ceilings, never past.
            new_t = min(self._ceil_timeout,
                        max(cur_t * self._grow,
                            min(_TIMEOUT_GROW_FLOOR_MS,
                                self._ceil_timeout)))
            new_q = min(self._ceil_queue,
                        max(int(cur_q * self._grow), cur_q + 1))
            if new_t != cur_t or new_q != cur_q:
                return ("relax", new_t, new_q)
        return None                 # dead band (or at the ceilings): hold

    def step(self, now: float | None = None) -> Adjustment | None:
        """One controller tick: window the objective, decide, actuate.
        Rate-limited — a call before ``interval_s`` has elapsed since the
        last ACTED tick returns None without reading the histogram (the
        window stays intact for the on-time tick). Returns the applied
        :class:`Adjustment` or None."""
        now = self._clock() if now is None else now
        if now - self._last < self.interval_s:
            return None
        self._last = now
        p99, completed = self.window_p99()
        bad = self._bad_total()
        bad_delta = bad - self._prev_bad
        self._prev_bad = bad
        knobs = self.engine.knobs
        registry = self.engine.registry
        overloaded = (bad_delta > 0
                      or self.engine.queue_depth() >= knobs.max_queue)
        gauges = {
            "serve_controller_window_completed": float(completed),
            "serve_controller_window_bad": float(bad_delta),
        }
        if p99 is not None:
            # The last objective reading, as a gauge.
            gauges["serve_controller_p99_ms"] = p99
        registry.record_many(gauges)
        decision = self._decide(p99, overloaded, knobs)
        if decision is None:
            return None
        action, new_t, new_q = decision
        new = self.engine.set_knobs(batch_timeout_ms=new_t, max_queue=new_q)
        self.adjustments += 1
        registry.inc("serve_controller_adjustments_total")
        adj = Adjustment(action=action, p99_ms=float(p99),
                         batch_timeout_ms=new.batch_timeout_ms,
                         max_queue=new.max_queue)
        log.info("serve controller %s: p99 %.1f ms vs target %.1f -> "
                 "batch_timeout_ms=%.3g max_queue=%d", action, p99,
                 self.target_p99_ms, new.batch_timeout_ms, new.max_queue)
        if self._obs is not None:
            # Flight-ring visibility: every adjustment is an event, so a
            # post-incident bundle shows WHAT the controller did and on
            # which objective reading (gated off internally when the
            # recorder is off).
            self._obs.record("serve_controller_adjust", action=action,
                             p99_ms=round(float(p99), 3),
                             window_completed=completed,
                             window_bad=bad_delta,
                             batch_timeout_ms=new.batch_timeout_ms,
                             max_queue=new.max_queue)
        return adj
