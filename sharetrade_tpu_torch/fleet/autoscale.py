"""Fleet autoscaler: the telemetry loop closed into fleet MEMBERSHIP.

A copy of the JAX package's ``fleet/autoscale.py`` (without its flight-ring
events, which wait for ``obs.enabled``). The router appends its gauge row
(fleet SLO availability burn, aggregate queue depth, overload, live-engine
count) to the bounded on-disk history ring every poll (obs/tsdb.py,
``fleet_history.jsonl``). This module is the actuator: a controller thread
that reads that ring and drives :meth:`EnginePool.scale`:

- **signals, windowed**: the last ``fleet.autoscale_window`` history
  rows. Scale-up wants SUSTAINED pressure — mean availability burn at
  or past ``autoscale_burn_high`` (1.0 = spending the whole error
  budget), mean per-engine queue depth past ``autoscale_queue_high``,
  or overload on at least half the window's rows. One bad poll is
  noise; a bad window is load.
- **hysteresis**: scale-DOWN needs a 2x-longer window in which EVERY
  row is quiet (burn under ``autoscale_burn_low``, per-engine queue
  under ``autoscale_queue_low``, zero overload). Everything between
  the up and down thresholds is the DEAD BAND: hold.
- **bounded, rate-limited steps**: at most ONE engine per decision,
  at most one APPLIED decision per ``autoscale_cooldown_s`` — capacity
  changes lag their own effect (a spawning engine takes seconds to
  serve), and an unbounded step amplifies that lag into overshoot.
- **config is the ceiling**: the target is clamped to
  [``fleet.min_engines``, ``fleet.max_engines`` (0 = num_engines)].
- **scale-down is state-preserving**: a retired engine drains through
  SIGTERM → page-out-all → exit 75, sealing every live and parked carry
  into the fleet-shared spill arena before the process dies — survivors
  ADOPT those sessions warm (step-stamp validated) instead of
  cold-restarting them through prefill.

What the autoscaler may ASSUME about the history ring: rows are appended
oldest-to-newest at the router's poll cadence, each a flat ``{"ts":
epoch_s, **gauges}`` dict; a torn tail line is dropped by
``read_history``, not raised; gauge keys are ABSENT (not zero) when there
was no signal that poll — the decision treats a missing burn/queue/
overload key as quiet, and a missing file or short ring as "not enough
evidence: hold".

Every decision is visible: ``fleet_autoscale_target`` gauge,
``fleet_autoscale_up_total`` / ``fleet_autoscale_down_total`` counters and
an atomically rewritten ``fleet_autoscale.json`` (target, actual, last
decision + reason).

Deterministic by construction: :meth:`step` takes a fake ``now``,
:meth:`decide` is a pure function of (rows, current target), and tests
drive both with stubbed telemetry rows — no subprocesses, no router, no
sleeps.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, NamedTuple

from sharetrade_tpu_torch.config import ConfigError, FleetConfig
from sharetrade_tpu_torch.obs.tsdb import FLEET_HISTORY_FILE, read_history
from sharetrade_tpu_torch.utils.logging import get_logger

log = get_logger("fleet.autoscale")

#: The autoscaler's state file (next to fleet_status.json).
AUTOSCALE_STATE_FILE = "fleet_autoscale.json"


class ScaleDecision(NamedTuple):
    """One applied membership change (the :meth:`EngineAutoscaler.step`
    return value)."""

    action: str                 # "up" | "down"
    target: int
    reason: str


class EngineAutoscaler:
    """See the module docstring. Duck-typed against the pool surface
    (``scale`` / ``live_count`` / ``target``), so tests drive it with a
    stub pool, stubbed history rows, and a fake clock."""

    def __init__(self, pool: Any, cfg: FleetConfig, *,
                 workdir: str | None = None, registry: Any = None,
                 clock=time.monotonic):
        if cfg.min_engines < 1:
            raise ConfigError(
                f"fleet.min_engines must be >= 1, got {cfg.min_engines}")
        ceiling = cfg.max_engines if cfg.max_engines > 0 else cfg.num_engines
        if ceiling < cfg.min_engines:
            raise ConfigError(
                f"fleet.max_engines ({ceiling}) must be >= fleet."
                f"min_engines ({cfg.min_engines})")
        if cfg.autoscale_interval_s <= 0 or cfg.autoscale_cooldown_s < 0:
            raise ConfigError(
                "fleet.autoscale_interval_s must be > 0 and "
                f"autoscale_cooldown_s >= 0, got "
                f"{cfg.autoscale_interval_s}/{cfg.autoscale_cooldown_s}")
        if cfg.autoscale_window < 1:
            raise ConfigError(
                f"fleet.autoscale_window must be >= 1, got "
                f"{cfg.autoscale_window}")
        if not (0.0 <= cfg.autoscale_burn_low < cfg.autoscale_burn_high):
            raise ConfigError(
                "fleet.autoscale_burn_low/high need 0 <= low < high, got "
                f"{cfg.autoscale_burn_low}/{cfg.autoscale_burn_high}")
        if not (0.0 <= cfg.autoscale_queue_low < cfg.autoscale_queue_high):
            raise ConfigError(
                "fleet.autoscale_queue_low/high need 0 <= low < high, "
                f"got {cfg.autoscale_queue_low}/"
                f"{cfg.autoscale_queue_high}")
        self.pool = pool
        self.cfg = cfg
        self.floor = int(cfg.min_engines)
        self.ceiling = int(ceiling)
        self.dir = workdir or cfg.dir
        self.registry = registry
        self._clock = clock
        self._last_step = clock()
        #: Monotonic stamp of the last APPLIED scaling (the cooldown
        #: anchor); 0 = never scaled, first decision is free.
        self._last_applied = 0.0
        self.decisions = 0
        self._last_decision: dict = {}
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # -- thread plumbing ----------------------------------------------

    def start(self) -> "EngineAutoscaler":
        """Run :meth:`step` every ``autoscale_interval_s`` on a daemon
        thread (the wait rides the stop event — no bare sleeps)."""
        self._thread = threading.Thread(target=self._loop,
                                        name="fleet-autoscale",
                                        daemon=True)
        self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.cfg.autoscale_interval_s):
            try:
                self.step()
            except Exception:   # noqa: BLE001 — an autoscaler fault must
                # degrade to "membership stops adapting", never kill the
                # fleet.
                log.exception("fleet autoscale step failed; holding "
                              "current membership")

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(5.0)

    # -- the control loop ---------------------------------------------

    @staticmethod
    def _row_signals(row: dict) -> tuple[float, float, float]:
        """(burn, per-engine queue depth, overload) of one history row;
        a missing key reads as quiet — absence of a gauge is absence of
        the signal, never an error (the ring contract)."""
        burn = float(row.get("fleet_slo_availability_burn", 0.0) or 0.0)
        engines = max(1.0, float(row.get("fleet_engines_live", 1.0)
                                 or 1.0))
        depth = float(row.get("fleet_queue_depth", 0.0) or 0.0) / engines
        overload = float(row.get("fleet_overload", 0.0) or 0.0)
        return burn, depth, overload

    def decide(self, rows: list[dict], current: int
               ) -> tuple[int, str] | None:
        """The pure state machine: ``(new_target, reason)`` or None
        (hold). ``rows`` oldest-first (the ``read_history`` order),
        ``current`` the pool's present target."""
        cfg = self.cfg
        win = cfg.autoscale_window
        if len(rows) >= win:
            recent = rows[-win:]
            sig = [self._row_signals(r) for r in recent]
            mean_burn = sum(s[0] for s in sig) / win
            mean_depth = sum(s[1] for s in sig) / win
            overloaded = sum(s[2] > 0 for s in sig)
            if current < self.ceiling:
                if mean_burn >= cfg.autoscale_burn_high:
                    return (current + 1,
                            f"availability burn {mean_burn:.2f} >= "
                            f"{cfg.autoscale_burn_high:g} over {win} polls")
                if mean_depth >= cfg.autoscale_queue_high:
                    return (current + 1,
                            f"queue depth {mean_depth:.1f}/engine >= "
                            f"{cfg.autoscale_queue_high:g} over {win} "
                            f"polls")
                if 2 * overloaded >= win:
                    return (current + 1,
                            f"overload on {overloaded}/{win} polls")
        # Scale-down hysteresis: a 2x-longer window, EVERY row quiet.
        quiet_win = 2 * win
        if current > self.floor and len(rows) >= quiet_win:
            quiet = True
            for row in rows[-quiet_win:]:
                burn, depth, overload = self._row_signals(row)
                if (burn >= cfg.autoscale_burn_low
                        or depth >= cfg.autoscale_queue_low
                        or overload > 0):
                    quiet = False
                    break
            if quiet:
                return (current - 1,
                        f"quiet {quiet_win} polls (burn < "
                        f"{cfg.autoscale_burn_low:g}, queue < "
                        f"{cfg.autoscale_queue_low:g}/engine, no "
                        f"overload)")
        return None                 # dead band (or at the bounds): hold

    def read_rows(self) -> list[dict]:
        """The decision window's history rows (oldest-first) out of the
        router's ring; missing file = no evidence = empty."""
        path = os.path.join(self.dir, FLEET_HISTORY_FILE)
        return read_history(path, last_n=2 * self.cfg.autoscale_window)

    def step(self, now: float | None = None,
             rows: list[dict] | None = None) -> ScaleDecision | None:
        """One autoscaler tick: read the ring, decide, actuate.
        Rate-limited by ``autoscale_interval_s`` between reads and
        ``autoscale_cooldown_s`` between APPLIED scalings. Returns the
        applied :class:`ScaleDecision` or None."""
        now = self._clock() if now is None else now
        if now - self._last_step < self.cfg.autoscale_interval_s:
            return None
        self._last_step = now
        if rows is None:
            rows = self.read_rows()
        current = int(self.pool.target)
        actual = int(self.pool.live_count())
        decision = self.decide(rows, current)
        applied: ScaleDecision | None = None
        if decision is not None:
            target, reason = decision
            in_cooldown = (self._last_applied > 0.0
                           and now - self._last_applied
                           < self.cfg.autoscale_cooldown_s)
            if not in_cooldown:
                action = "up" if target > current else "down"
                self.pool.scale(target)
                self._last_applied = now
                self.decisions += 1
                applied = ScaleDecision(action=action, target=target,
                                        reason=reason)
                self._last_decision = {
                    "ts": time.time(), "action": action,
                    "from": current, "to": target, "reason": reason}
                log.info("fleet autoscale %s: %d -> %d engines (%s)",
                         action, current, target, reason)
                if self.registry is not None:
                    self.registry.inc(f"fleet_autoscale_{action}_total")
                current = target
        if self.registry is not None:
            self.registry.record_many({
                "fleet_autoscale_target": float(current),
                "fleet_autoscale_actual": float(actual)})
        self._write_state(current, actual)
        return applied

    def _write_state(self, target: int, actual: int) -> None:
        """Atomically rewrite the autoscaler state file."""
        if not self.dir:
            return
        path = os.path.join(self.dir, AUTOSCALE_STATE_FILE)
        tmp = f"{path}.tmp-{os.getpid()}"
        state = {
            "ts": time.time(), "target": target, "actual": actual,
            "floor": self.floor, "ceiling": self.ceiling,
            "decisions": self.decisions,
            "last_decision": self._last_decision or None,
        }
        try:
            os.makedirs(self.dir, exist_ok=True)
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(state, f, indent=2)
            os.replace(tmp, path)
        except OSError:
            log.exception("fleet autoscale state write failed")
