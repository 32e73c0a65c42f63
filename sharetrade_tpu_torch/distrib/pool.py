""":class:`ActorPool`: the rollout actors' supervisor, the supervision
contract applied at PROCESS granularity.

Counterpart of the JAX package's ``distrib/pool.py``. The reference wraps
each worker in a BackoffSupervisor envelope (TrainerRouterActor.scala:
46-52) inside one JVM; here each worker is a whole OS process (``python -m
sharetrade_tpu_torch.cli actor ... --device <the pool's device>``) and the
pool is its supervisor:

- **spawn/reap**: ``start()`` launches N rollout-actor subprocesses; the
  supervise thread polls (``_reap``) and classifies every exit: a retiring
  actor (scale-down, shutdown) retires quietly, anything else is a CRASH;
- **seeded exponential backoff**: a crashed actor respawns after
  ``distrib.actor_backoff_initial_s * 2^(streak-1)`` (capped, jittered from
  the run's seed), through the shared ladder (``distrib/ladder.py``);
- **terminal failure**: a consecutive-crash streak past
  ``distrib.max_actor_restarts`` marks the actor FAILED and the pool
  degrades onto the survivors. The streak resets once a respawned actor
  proves healthy: its heartbeat reaches the ``rolling`` phase;
- **heartbeats**: every actor's heartbeat age is read each tick, exported
  as gauges, and with ``distrib.heartbeat_timeout_s`` set a silent actor is
  presumed wedged and killed (a crash, so the ladder applies);
- **elastic membership**: ``scale(n)`` adds fresh actors or retires the
  newest ones against a live learner (a retiring actor gets SIGTERM and
  drains); the ``scale`` control file in the pool dir drives the same call
  from outside the process;
- **observability**: gauges ``actors_alive`` / ``actors_failed`` /
  ``actors_backoff``, counter ``actor_restarts_total``, per-actor
  heartbeat-age gauges, and an atomically rewritten ``status.json`` naming
  every member's pid, state, restarts, heartbeat age and progress.

Retired and failed handles stay in the roster: ``restarts_total`` must
equal the sum over every member ever spawned, and a post-mortem needs the
whole membership history.

``spawn_fn(actor_id, workdir) -> Popen`` overrides the spawn command (the
supervision tests drive the ladder with cheap stub children).
"""

from __future__ import annotations

import json
import os
import random
import signal
import subprocess
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable

from sharetrade_tpu_torch.config import ConfigError, FrameworkConfig
from sharetrade_tpu_torch.distrib.actor import (
    HEARTBEAT_FILE, TRANSITIONS_FILE, read_heartbeat)
from sharetrade_tpu_torch.distrib.ladder import (
    ALIVE,
    BACKOFF,
    FAILED,
    RETIRED,
    RETIRING,
    STARTING,
    LadderPolicy,
    crash_step,
)
from sharetrade_tpu_torch.utils.logging import get_logger

log = get_logger("distrib.pool")

STATUS_FILE = "status.json"
SCALE_FILE = "scale"
CONFIG_FILE = "actor_config.json"


def read_status(pool_dir: str) -> dict | None:
    """Read the pool's status.json (None when absent/torn — the write is
    atomic, so torn means 'not written yet')."""
    try:
        with open(os.path.join(pool_dir, STATUS_FILE),
                  encoding="utf-8") as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


@dataclass
class _ActorHandle:
    actor_id: str
    proc: subprocess.Popen | None = None
    state: str = STARTING
    restarts: int = 0
    streak: int = 0
    spawned_at: float = 0.0
    respawn_at: float = 0.0
    last_rc: int | None = None
    heartbeat: dict = field(default_factory=dict)
    heartbeat_age_s: float | None = None

    @property
    def pid(self) -> int | None:
        return self.proc.pid if self.proc is not None else None


class ActorPool:
    """Supervisor for ``cli actor`` subprocesses (see module docstring).
    Every actor runs on ``device`` (``cuda`` by default), the learner's.

    ``spawn_fn(actor_id, workdir) -> Popen`` overrides the spawn command —
    the supervision tests drive the reap/backoff/terminal ladder with a
    cheap stub child instead of a full actor bring-up."""

    def __init__(self, cfg: FrameworkConfig, *, workdir: str | None = None,
                 registry: Any = None, symbol: str = "MSFT",
                 start: str | None = None, end: str | None = None,
                 device: str = "cuda",
                 spawn_fn: Callable[[str, str], subprocess.Popen]
                 | None = None):
        dc = cfg.distrib
        if dc.max_actor_restarts < 0:
            raise ConfigError("distrib.max_actor_restarts must be >= 0, "
                              f"got {dc.max_actor_restarts}")
        self.cfg = cfg
        self.dir = workdir or dc.actor_dir
        os.makedirs(self.dir, exist_ok=True)
        self.registry = registry
        self._symbol, self._start, self._end = symbol, start, end
        self._device = str(device)
        self._spawn_fn = spawn_fn
        self._rng = random.Random(cfg.seed ^ 0xAC7)
        self._actors: dict[str, _ActorHandle] = {}
        self._next_index = 0
        self._scale_file_applied: int | None = None
        self.target = 0
        self.restarts_total = 0
        self.scale_events = 0
        self._lock = threading.RLock()
        self._stop = threading.Event()
        self._quiesced = threading.Event()
        self._thread: threading.Thread | None = None
        self._config_path: str | None = None
        self.started_at = time.time()

    # ---- membership -------------------------------------------------

    def start(self, n: int | None = None) -> "ActorPool":
        """Spawn the initial membership and the supervise thread."""
        n = self.cfg.distrib.num_actors if n is None else n
        with self._lock:
            self.target = n
            for _ in range(n):
                self._spawn_new_locked()
            self._write_status_locked()
        self._thread = threading.Thread(target=self._supervise,
                                        name="actor-pool", daemon=True)
        self._thread.start()
        return self

    def scale(self, n: int) -> None:
        """Elastic membership against a LIVE learner: grow by spawning
        fresh actors, shrink by retiring the newest non-failed ones
        (SIGTERM -> graceful drain -> retired). Terminally-failed actors
        do not count toward the target — scaling past a failure is
        exactly how an operator replaces a dead member."""
        if self._quiesced.is_set():
            # The learner is draining: a scale request now would spawn
            # fresh actors into a dying run (the respawn path already
            # refuses for the same reason).
            log.warning("pool is quiescing; ignoring scale(%d)", n)
            return
        with self._lock:
            if n < 0:
                raise ConfigError(f"cannot scale to {n} actors")
            self.target = n
            self.scale_events += 1
            live = [h for h in self._actors.values()
                    if h.state in (STARTING, ALIVE, BACKOFF)]
            if n > len(live):
                for _ in range(n - len(live)):
                    self._spawn_new_locked()
            elif n < len(live):
                # Retire the newest members: NUMERIC spawn order, not
                # lexical actor_id order ("a9" > "a10" lexically).
                for h in sorted(live, key=lambda h: int(h.actor_id[1:]),
                                reverse=True)[:len(live) - n]:
                    self._retire_locked(h)
            self._write_status_locked()
            membership = {h.actor_id: h.state
                          for h in self._actors.values()}
        log.info("actor pool scaled to %d (membership now %s)", n,
                 membership)

    def _spawn_new_locked(self) -> _ActorHandle:
        actor_id = f"a{self._next_index}"
        self._next_index += 1
        handle = _ActorHandle(actor_id=actor_id)
        self._actors[actor_id] = handle
        self._spawn_locked(handle)
        return handle

    def _spawn_locked(self, handle: _ActorHandle) -> None:
        workdir = os.path.join(self.dir, handle.actor_id)
        os.makedirs(workdir, exist_ok=True)
        # A stale heartbeat from the previous incarnation must not make a
        # just-respawned actor look instantly healthy (the streak-reset
        # and timeout logic key off phase/pid below, but age math does
        # not need a dead process's stamp).
        try:
            os.remove(os.path.join(workdir, HEARTBEAT_FILE))
        except FileNotFoundError:
            pass
        if self._spawn_fn is not None:
            handle.proc = self._spawn_fn(handle.actor_id, workdir)
        else:
            if self._config_path is None:
                self._config_path = os.path.join(self.dir, CONFIG_FILE)
                self.cfg.save(self._config_path)
            cmd = [sys.executable, "-m", "sharetrade_tpu_torch.cli", "actor",
                   "--config", self._config_path,
                   "--actor-id", handle.actor_id,
                   "--symbol", self._symbol, "--device", self._device]
            if self._start:
                cmd += ["--start", self._start]
            if self._end:
                cmd += ["--end", self._end]
            # Merged child output to a per-actor FILE (a pipe nobody
            # drains wedges the child at ~64 KB — the crash-soak lesson).
            log_f = open(os.path.join(self.dir,
                                      f"{handle.actor_id}.log"), "ab")
            try:
                handle.proc = subprocess.Popen(
                    cmd, stdout=log_f, stderr=subprocess.STDOUT)
            finally:
                log_f.close()
        handle.state = STARTING
        handle.spawned_at = time.monotonic()
        handle.respawn_at = 0.0
        handle.heartbeat = {}           # predecessor's stamp is not ours
        handle.heartbeat_age_s = None
        log.info("actor %s spawned (pid %s)", handle.actor_id, handle.pid)

    def _retire_locked(self, handle: _ActorHandle) -> None:
        if handle.proc is not None and handle.proc.poll() is None:
            handle.state = RETIRING
            try:
                handle.proc.send_signal(signal.SIGTERM)
            except ProcessLookupError:
                pass
        else:
            handle.state = RETIRED

    # ---- supervision ------------------------------------------------

    def _supervise(self) -> None:
        interval = max(self.cfg.distrib.supervise_interval_s, 0.05)
        while not self._stop.wait(interval):
            try:
                self.poll_once()
            except Exception:   # noqa: BLE001 — the supervisor outlives
                log.exception("actor-pool supervise tick failed")

    def poll_once(self) -> None:
        """One supervise tick (public so tests and a synchronous driver
        can step the pool deterministically): reap exits, age heartbeats,
        enforce the heartbeat timeout, respawn due backoffs, apply the
        scale control file, publish status + gauges."""
        with self._lock:
            self._reap()
            ages = self._heartbeat_ages()
            self._enforce_heartbeat_timeout(ages)
            self._respawn_due()
            self._apply_scale_file()
            self._write_status_locked()
            self._export_gauges(ages)

    def quiesce(self) -> None:
        """Stop respawning: the LEARNER is preempting (SIGTERM to the
        whole process group — a fleet preemption TERMs every member at
        once), so an actor exiting from here on is draining, not
        crashing. Without this, the pool reaps the concurrently-TERM'd
        actors' graceful exits as crashes and respawns fresh actors into
        a dying run (observed: pid storm during the drain window)."""
        self._quiesced.set()

    def _reap(self) -> None:
        """Classify every exited child: retiring -> retired; anything
        else is a crash feeding the backoff/terminal ladder."""
        dc = self.cfg.distrib
        for h in self._actors.values():
            if h.proc is None or h.state in (FAILED, RETIRED, BACKOFF):
                continue
            rc = h.proc.poll()
            if rc is None:
                continue
            h.last_rc = rc
            if h.state == RETIRING or self._quiesced.is_set():
                h.state = RETIRED
                log.info("actor %s retired (rc=%s)", h.actor_id, rc)
                continue
            h.streak += 1
            h.restarts += 1
            self.restarts_total += 1
            if self.registry is not None:
                self.registry.inc("actor_restarts_total")
            # The shared supervision ladder (distrib/ladder.py): one
            # definition of terminal-vs-backoff and the seeded jittered
            # exponential schedule, shared with the fleet's EnginePool.
            state, delay = crash_step(
                h.streak,
                LadderPolicy(max_restarts=dc.max_actor_restarts,
                             backoff_initial_s=dc.actor_backoff_initial_s,
                             backoff_max_s=dc.actor_backoff_max_s,
                             backoff_jitter=dc.actor_backoff_jitter),
                self._rng)
            h.state = state
            if state == FAILED:
                log.error(
                    "actor %s FAILED terminally: %d consecutive crashes "
                    "past distrib.max_actor_restarts=%d (last rc=%s); "
                    "pool degrades onto the survivors",
                    h.actor_id, h.streak, dc.max_actor_restarts, rc)
                continue
            h.respawn_at = time.monotonic() + delay
            log.warning("actor %s crashed (rc=%s); restart %d "
                        "(streak %d/%d) in %.2fs", h.actor_id, rc,
                        h.restarts, h.streak, dc.max_actor_restarts, delay)

    def _heartbeat_ages(self) -> dict[str, float | None]:
        """Read every member's heartbeat stamp; a ``rolling``-phase
        heartbeat from the CURRENT incarnation proves the respawn healthy
        and resets its crash streak."""
        now = time.time()
        ages: dict[str, float | None] = {}
        for h in self._actors.values():
            if h.state in (RETIRED, FAILED):
                # A corpse's heartbeat file lingers on disk: re-reading
                # it every tick exports an ever-climbing age gauge that
                # reads as a wedged actor (and costs one file read per
                # dead member forever under elastic churn).
                continue
            hb = read_heartbeat(os.path.join(self.dir, h.actor_id,
                                             HEARTBEAT_FILE))
            if hb is None:
                h.heartbeat_age_s = None
                ages[h.actor_id] = None
                continue
            h.heartbeat = hb
            h.heartbeat_age_s = max(0.0, now - float(hb.get("time", 0.0)))
            ages[h.actor_id] = h.heartbeat_age_s
            if (h.state == STARTING and hb.get("pid") == h.pid
                    and hb.get("phase") == "rolling"):
                h.state = ALIVE
                h.streak = 0
        return ages

    def _enforce_heartbeat_timeout(
            self, ages: dict[str, float | None]) -> None:
        timeout = self.cfg.distrib.heartbeat_timeout_s
        if timeout <= 0:
            return
        for h in self._actors.values():
            # ALIVE actors, and STARTING ones that have stamped at least
            # once from the CURRENT incarnation (a wedge during bring-up
            # must not escape the contract; before the first stamp there
            # is no age to enforce — the spawn wiped the predecessor's).
            if h.state not in (ALIVE, STARTING) or h.proc is None \
                    or h.proc.poll() is not None:
                continue
            if h.state == STARTING and h.heartbeat.get("pid") != h.pid:
                continue
            age = ages.get(h.actor_id)
            if age is not None and age > timeout:
                log.error("actor %s heartbeat stale (%.1fs > %.1fs); "
                          "killing the presumed-wedged process",
                          h.actor_id, age, timeout)
                try:
                    h.proc.kill()    # the next _reap classifies the crash
                except ProcessLookupError:
                    pass

    def _respawn_due(self) -> None:
        if self._quiesced.is_set():
            return
        now = time.monotonic()
        for h in self._actors.values():
            if h.state == BACKOFF and now >= h.respawn_at:
                self._spawn_locked(h)

    def _apply_scale_file(self) -> None:
        """The out-of-process elastic-membership lever: an operator (or
        the kill-test) writes a target count into ``<dir>/scale`` and the
        live pool converges to it — no learner restart, no IPC beyond a
        file the status already lives next to."""
        try:
            with open(os.path.join(self.dir, SCALE_FILE),
                      encoding="utf-8") as f:
                n = int(f.read().strip())
        except (OSError, ValueError):
            return
        if n < 0:
            # Validated here, not in scale(): a ConfigError out of the
            # supervise tick would re-raise every interval for as long
            # as the file holds the bad value.
            return
        if n != self._scale_file_applied:
            # Compare against the last APPLIED file value, not the
            # target: a lingering file must not silently re-undo a later
            # programmatic scale() call on every supervise tick.
            self._scale_file_applied = n
            if n != self.target:
                # scale() re-enters the lock (RLock), rewrites status.
                self.scale(n)

    # ---- observability ----------------------------------------------

    def counts(self) -> dict[str, int]:
        with self._lock:
            states = [h.state for h in self._actors.values()]
        return {
            "alive": sum(s in (STARTING, ALIVE, RETIRING) for s in states),
            "backoff": sum(s == BACKOFF for s in states),
            "failed": sum(s == FAILED for s in states),
            "retired": sum(s == RETIRED for s in states),
        }

    def _export_gauges(self, ages: dict[str, float | None]) -> None:
        if self.registry is None:
            return
        c = self.counts()
        self.registry.record("actors_alive", float(c["alive"]))
        self.registry.record("actors_failed", float(c["failed"]))
        self.registry.record("actors_backoff", float(c["backoff"]))
        for actor_id, age in ages.items():
            if age is not None:
                self.registry.record(
                    f"actor_heartbeat_age_s_{actor_id}", age)

    def _write_status_locked(self) -> None:
        status = {
            "pid": os.getpid(),
            "started_at": self.started_at,
            "target": self.target,
            "restarts_total": self.restarts_total,
            "scale_events": self.scale_events,
            **self.counts(),
            "actors": {
                h.actor_id: {
                    "pid": h.pid, "state": h.state,
                    "restarts": h.restarts, "streak": h.streak,
                    "last_rc": h.last_rc,
                    "heartbeat_age_s": h.heartbeat_age_s,
                    "env_steps": h.heartbeat.get("env_steps"),
                    "rows": h.heartbeat.get("rows"),
                    "params_step": h.heartbeat.get("params_step"),
                } for h in self._actors.values()},
        }
        tmp = os.path.join(self.dir, f".{STATUS_FILE}.tmp-{os.getpid()}")
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(status, f, indent=2)
        os.replace(tmp, os.path.join(self.dir, STATUS_FILE))

    def journal_paths(self) -> dict[str, str]:
        """Per-actor transitions-journal paths (the learner's ingest set)."""
        with self._lock:
            return {aid: os.path.join(self.dir, aid, TRANSITIONS_FILE)
                    for aid in self._actors}

    # ---- shutdown ---------------------------------------------------

    def kill_all(self) -> None:
        """Last-resort fleet teardown for the learner's HARD-exit paths
        (drain grace expired, second signal): ``os._exit`` skips every
        finally block, so anything not killed here is an orphaned actor
        process rolling out forever with no supervisor. SIGKILL — there
        is no time left to drain."""
        self._quiesced.set()
        with self._lock:
            for h in self._actors.values():
                if h.proc is not None and h.proc.poll() is None:
                    try:
                        h.proc.kill()
                    except ProcessLookupError:
                        pass

    def stop(self, grace_s: float = 15.0) -> None:
        """Drain the fleet: SIGTERM every live actor (they drain their
        journals and exit 75 like ``cli train``), SIGKILL stragglers past
        the grace, stop the supervise thread, publish a final status."""
        self._quiesced.set()
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=grace_s)
        with self._lock:
            live = [h for h in self._actors.values()
                    if h.proc is not None and h.proc.poll() is None]
            for h in live:
                h.state = RETIRING
                try:
                    h.proc.send_signal(signal.SIGTERM)
                except ProcessLookupError:
                    pass
        deadline = time.monotonic() + grace_s
        for h in live:
            timeout = max(0.1, deadline - time.monotonic())
            try:
                h.proc.wait(timeout=timeout)
            except subprocess.TimeoutExpired:
                log.warning("actor %s did not drain in %.1fs; SIGKILL",
                            h.actor_id, grace_s)
                h.proc.kill()
                h.proc.wait(timeout=10)
            h.last_rc = h.proc.returncode
            h.state = RETIRED
        with self._lock:
            self._write_status_locked()
