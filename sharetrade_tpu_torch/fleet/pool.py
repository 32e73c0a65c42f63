""":class:`EnginePool` — whole serve-engine WORKER PROCESSES under the
shared supervision ladder.

A copy of the JAX package's ``fleet/pool.py``. Each member is one ``python
-m sharetrade_tpu_torch.cli serve --listen ... --device <device>``
subprocess: a full overload-safe :class:`~sharetrade_tpu_torch.serve.
engine.ServeEngine` (its own slot arena, admission control, swap watcher)
behind its own network front-end (fleet/frontend.py) on an EPHEMERAL port
the worker reports in a machine-readable ``engine_listening`` line. The
ladder itself — crash classification, seeded exponential backoff,
consecutive-streak terminal failure — is distrib/ladder.py's:

- **spawn/reap**: classify every exit; quiesced/retiring exits retire
  quietly, anything else crashes into the ladder;
- **bring-up watch**: a worker that never prints its listening line
  within ``fleet.startup_timeout_s`` is presumed wedged during startup
  and killed (a crash — bring-up hangs must not escape the contract). A
  worker that cannot build or launch its CUDA kernels fails its warm-up
  and exits before it listens, so it too climbs the ladder; it never
  serves on the CPU unless the pool's ``device`` is ``cpu``;
- **HTTP heartbeats**: each supervise tick polls every listening
  member's ``/healthz``; a member silent past
  ``fleet.health_timeout_s`` is killed (crash → ladder). The health
  snapshot (queue depth, params_step, swap counters) rides into
  ``status`` — the router's membership view;
- **terminal degrade**: a streak past ``fleet.max_engine_restarts``
  marks the engine FAILED and the fleet degrades onto survivors; the
  router answers 503 loudly when none remain;
- **CPU slices** (``fleet.engine_cpus``): each worker is pinned to its
  own core slice via ``sched_setaffinity`` at spawn.

A healthy engine that gets SIGKILLed respawns FRESH: empty slot pool,
empty warm store. What SURVIVES the corpse is the shared spill arena: when
``serve.spill_bytes`` is configured the pool hands every worker the same
``<dir>/spill`` directory (or ``serve.spill_dir``), so carries the dead
engine parked/spilled there are ADOPTED warm by whichever engine the
router re-routes each session to — iff the record's step stamp matches the
router's session clock; anything stale, torn, or CRC-bad re-enters COLD
through the batched prefill. The pool also sweeps dead incarnations'
unsealed ``.tmp`` debris out of the arena: at boot (nothing is running —
all debris is dead) and on every crash reap (the corpse's pid-stamped
leftovers).
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable

from sharetrade_tpu_torch.config import ConfigError, FrameworkConfig
from sharetrade_tpu_torch.distrib.ladder import (
    ALIVE,
    BACKOFF,
    FAILED,
    LIVE_STATES,
    RETIRED,
    RETIRING,
    STARTING,
    LadderPolicy,
    crash_step,
)
from sharetrade_tpu_torch.fleet.wire import FleetClient
from sharetrade_tpu_torch.serve.spill import sweep_debris
from sharetrade_tpu_torch.utils.logging import get_logger

log = get_logger("fleet.pool")

ENGINE_CONFIG_FILE = "engine_config.json"

#: The worker's machine-readable readiness line (``cli serve --listen``
#: prints it once the front-end is bound): the pool tails each worker's
#: log file for it to learn the ephemeral port.
LISTENING_EVENT = "engine_listening"


@dataclass
class _EngineHandle:
    engine_id: str
    proc: subprocess.Popen | None = None
    state: str = STARTING
    restarts: int = 0
    streak: int = 0
    spawned_at: float = 0.0
    respawn_at: float = 0.0
    last_rc: int | None = None
    port: int | None = None
    #: monotonic stamp of the last successful /healthz (or of the
    #: listening line, which proves the same liveness).
    last_ok: float = 0.0
    health: dict = field(default_factory=dict)
    log_path: str = ""
    _log_offset: int = 0
    cpus: tuple[int, ...] = ()

    @property
    def pid(self) -> int | None:
        return self.proc.pid if self.proc is not None else None


class EnginePool:
    """Supervisor for ``cli serve --listen`` workers (module docstring).

    ``device`` is the torch device every worker serves on (``--device``;
    the caller resolves it, as ``cli fleet`` does). ``spawn_fn(engine_id,
    log_path) -> Popen`` substitutes the spawn for tests: the stub child
    owns writing its own ``engine_listening`` line into ``log_path``."""

    def __init__(self, cfg: FrameworkConfig, *, workdir: str | None = None,
                 registry: Any = None, symbol: str = "MSFT",
                 start: str | None = None, end: str | None = None,
                 device: str = "cuda",
                 spawn_fn: Callable[[str, str], subprocess.Popen]
                 | None = None):
        fc = cfg.fleet
        LadderPolicy(
            max_restarts=fc.max_engine_restarts,
            backoff_initial_s=fc.engine_backoff_initial_s,
            backoff_max_s=fc.engine_backoff_max_s,
            backoff_jitter=fc.engine_backoff_jitter,
        ).validate(section="fleet.max_engine_restarts / engine_backoff_*")
        if fc.num_engines < 1:
            raise ConfigError(
                f"fleet.num_engines must be >= 1, got {fc.num_engines}")
        self.cfg = cfg
        self.dir = workdir or fc.dir
        os.makedirs(self.dir, exist_ok=True)
        self.registry = registry
        self._symbol, self._start, self._end = symbol, start, end
        self._device = str(device)
        self._spawn_fn = spawn_fn
        import random
        self._rng = random.Random(cfg.seed ^ 0xF1EE7)
        self._policy = LadderPolicy(
            max_restarts=fc.max_engine_restarts,
            backoff_initial_s=fc.engine_backoff_initial_s,
            backoff_max_s=fc.engine_backoff_max_s,
            backoff_jitter=fc.engine_backoff_jitter)
        self._engines: dict[str, _EngineHandle] = {}
        self._next_index = 0
        self.target = 0
        self.scale_events = 0
        self.restarts_total = 0
        self._lock = threading.RLock()
        self._stop = threading.Event()
        self._quiesced = threading.Event()
        self._thread: threading.Thread | None = None
        self._config_path: str | None = None
        self.started_at = time.time()
        #: Host core inventory for fleet.engine_cpus slices (stable
        #: round-robin assignment by spawn index).
        self._host_cpus = sorted(os.sched_getaffinity(0))
        #: The fleet-shared spill arena directory, or None
        #: with the spill tier off. An explicit serve.spill_dir wins;
        #: otherwise spill_bytes > 0 (and a live warm tier — the engine
        #: refuses spill-without-warm) roots the arena under the pool's
        #: own dir so every worker — and every respawn — shares it.
        sc = cfg.serve
        self.arena_dir: str | None = None
        if sc.spill_dir:
            self.arena_dir = sc.spill_dir
        elif sc.spill_bytes > 0 and sc.warm_bytes > 0:
            self.arena_dir = os.path.join(self.dir, "spill")

    # ---- membership -------------------------------------------------

    def start(self, n: int | None = None) -> "EnginePool":
        n = self.cfg.fleet.num_engines if n is None else n
        if self.arena_dir is not None:
            # Nothing is running yet, so EVERY unsealed temp file in the
            # arena is a dead incarnation's torn write — sealed records
            # are untouched (they are the previous fleet's adoptable
            # carries, exactly what the spill tier exists to preserve).
            swept = sweep_debris(self.arena_dir)
            if swept:
                log.info("swept %d stale spill temp file(s) from %s",
                         swept, self.arena_dir)
        with self._lock:
            self.target = n
            for _ in range(n):
                self._spawn_new_locked()
        self._thread = threading.Thread(target=self._supervise,
                                        name="engine-pool", daemon=True)
        self._thread.start()
        return self

    def _spawn_new_locked(self) -> _EngineHandle:
        engine_id = f"e{self._next_index}"
        idx = self._next_index
        self._next_index += 1
        handle = _EngineHandle(engine_id=engine_id)
        handle.cpus = self._cpu_slice(idx)
        self._engines[engine_id] = handle
        self._spawn_locked(handle)
        return handle

    def _cpu_slice(self, idx: int) -> tuple[int, ...]:
        k = self.cfg.fleet.engine_cpus
        if k <= 0 or not self._host_cpus:
            return ()
        n = len(self._host_cpus)
        lo = (idx * k) % n
        return tuple(self._host_cpus[(lo + j) % n] for j in range(min(k, n)))

    def _spawn_locked(self, handle: _EngineHandle) -> None:
        handle.log_path = os.path.join(self.dir,
                                       f"{handle.engine_id}.log")
        # The log appends across incarnations (crash forensics stay on
        # disk): anchor the listening-line scan at the CURRENT size so a
        # respawn can never re-read its predecessor's port line.
        try:
            handle._log_offset = os.path.getsize(handle.log_path)
        except OSError:
            handle._log_offset = 0
        if self._spawn_fn is not None:
            handle.proc = self._spawn_fn(handle.engine_id,
                                         handle.log_path)
        else:
            if self._config_path is None:
                self._config_path = os.path.join(self.dir,
                                                 ENGINE_CONFIG_FILE)
                worker_cfg = FrameworkConfig.from_dict(self.cfg.to_dict())
                # Engine telemetry is scraped over /metrics (the
                # router's poller), never written by the workers.
                worker_cfg.obs.enabled = False
                worker_cfg.save(self._config_path)
            cmd = [sys.executable, "-m", "sharetrade_tpu_torch.cli",
                   "serve", "--config", self._config_path,
                   "--listen", f"{self.cfg.fleet.host}:0",
                   "--duration", "0", "--device", self._device,
                   # Each worker's price-data layer scopes to its OWN
                   # dir: sharing journal_dir would contend for the
                   # price-event journal's flock'd writer lock.
                   "--set",
                   "data.journal_dir="
                   + os.path.join(self.dir, f"{handle.engine_id}-data"),
                   "--symbol", self._symbol]
            if self.arena_dir is not None:
                # Every worker shares ONE arena (and a respawn rejoins
                # it): the handoff half of warm-carry migration.
                cmd += ["--set", f"serve.spill_dir={self.arena_dir}"]
            span_dir = getattr(self.cfg.obs, "span_dir", "")
            if span_dir:
                # Span journaling: each worker appends wire spans to its
                # OWN journal in the fleet's shared spans dir, keyed by
                # engine id (no writer contention — one file per
                # process). The workers run obs.enabled=false; the span
                # journal is the one obs artifact deliberately shared,
                # switched by span_dir alone (obs/__init__.py).
                cmd += ["--set", f"obs.span_dir={span_dir}",
                        "--set", f"obs.span_proc=engine-{handle.engine_id}"]
            if self._start:
                cmd += ["--start", self._start]
            if self._end:
                cmd += ["--end", self._end]
            # Child output to a FILE, never a pipe: an undrained pipe
            # wedges the child at ~64 KB.
            log_f = open(handle.log_path, "ab")
            preexec = None
            if handle.cpus:
                cpus = handle.cpus
                # Pin the worker (and every thread it spawns) to its
                # slice; runs in the child between fork and exec, where
                # the parent may hold a CUDA context: touch nothing else.
                preexec = lambda: os.sched_setaffinity(0, cpus)  # noqa: E731
            try:
                # EnginePool IS this child's supervisor (reap, backoff
                # and the terminal ladder below).
                handle.proc = subprocess.Popen(  # actor-spawn-ok: supervised here
                    cmd, stdout=log_f, stderr=subprocess.STDOUT,
                    preexec_fn=preexec)
            finally:
                log_f.close()
        handle.state = STARTING
        handle.spawned_at = time.monotonic()
        handle.respawn_at = 0.0
        handle.port = None
        handle.last_ok = 0.0
        handle.health = {}
        log.info("engine %s spawned (pid %s, cpus %s)", handle.engine_id,
                 handle.pid, handle.cpus or "unpinned")

    # ---- supervision ------------------------------------------------

    def _supervise(self) -> None:
        interval = max(self.cfg.fleet.supervise_interval_s, 0.05)
        while not self._stop.wait(interval):
            try:
                self.poll_once()
            except Exception:   # noqa: BLE001 — the supervisor outlives
                log.exception("engine-pool supervise tick failed")

    def poll_once(self) -> None:
        """One supervise tick (public: tests step the pool
        deterministically): reap exits, scan for listening lines, poll
        heartbeats, enforce timeouts, respawn due backoffs, publish
        status + gauges."""
        with self._lock:
            self._reap()
            self._scan_listening()
        # Health polls go over HTTP — off the lock, so a slow peer never
        # blocks membership bookkeeping; results commit under it.
        self._poll_health()
        with self._lock:
            self._enforce_timeouts()
            self._respawn_due()
            self._write_status_locked()
            self._export_gauges()

    def quiesce(self) -> None:
        """Stop respawning: the fleet is draining — engines exiting from
        here on retire instead of crashing."""
        self._quiesced.set()

    def scale(self, n: int) -> None:
        """Retarget LIVE membership to ``n`` engines (the autoscaler's —
        and the operator's — actuator). Growing spawns fresh workers; shrinking
        retires the NEWEST live engines first (highest numeric id — the
        longest-lived members keep their warm slot pools and session
        affinity), each through the SIGTERM drain → exit-75 contract so
        in-flight requests finish and its sessions migrate cold. Refused
        while draining: a quiesced pool must not spawn."""
        if self._quiesced.is_set():
            log.warning("scale(%d) refused: pool is quiesced/draining", n)
            return
        with self._lock:
            if n < 0:
                raise ConfigError(f"scale target must be >= 0, got {n}")
            self.target = n
            self.scale_events += 1
            live = [h for h in self._engines.values()
                    if h.state in (STARTING, ALIVE, BACKOFF)]
            if len(live) < n:
                for _ in range(n - len(live)):
                    self._spawn_new_locked()
            elif len(live) > n:
                victims = sorted(
                    live, key=lambda h: int(h.engine_id[1:]),
                    reverse=True)[:len(live) - n]
                for h in victims:
                    self._retire_locked(h)
            self._write_status_locked()
            log.info("fleet scaled to target=%d (%s)", n,
                     {h.engine_id: h.state
                      for h in self._engines.values()})

    def _retire_locked(self, h: _EngineHandle) -> None:
        """Retire one engine: a live process drains via SIGTERM (its own
        drain → exit 75 contract; the next reap classifies the exit as a
        RETIRING retirement, never a crash); a dead/backing-off handle
        just retires in place."""
        if h.proc is not None and h.proc.poll() is None:
            h.state = RETIRING
            try:
                h.proc.send_signal(signal.SIGTERM)
            except ProcessLookupError:
                pass
        else:
            h.state = RETIRED

    def _reap(self) -> None:
        for h in self._engines.values():
            if h.proc is None or h.state in (FAILED, RETIRED, BACKOFF):
                continue
            rc = h.proc.poll()
            if rc is None:
                continue
            h.last_rc = rc
            h.port = None
            if self.arena_dir is not None and h.pid is not None:
                # The corpse can never finish a write: its pid-stamped
                # unsealed temp files are debris now (sealed records
                # stay — they are the adoption inventory).
                sweep_debris(self.arena_dir, pid=h.pid)
            if h.state == RETIRING or self._quiesced.is_set():
                h.state = RETIRED
                log.info("engine %s retired (rc=%s)", h.engine_id, rc)
                continue
            h.streak += 1
            h.restarts += 1
            self.restarts_total += 1
            if self.registry is not None:
                self.registry.inc("engine_restarts_total")
            state, delay = crash_step(h.streak, self._policy, self._rng)
            h.state = state
            if state == FAILED:
                log.error(
                    "engine %s FAILED terminally: %d consecutive crashes "
                    "past fleet.max_engine_restarts=%d (last rc=%s); "
                    "fleet degrades onto the survivors",
                    h.engine_id, h.streak,
                    self._policy.max_restarts, rc)
                continue
            h.respawn_at = time.monotonic() + delay
            log.warning("engine %s crashed (rc=%s); restart %d "
                        "(streak %d/%d) in %.2fs", h.engine_id, rc,
                        h.restarts, h.streak, self._policy.max_restarts,
                        delay)

    def _scan_listening(self) -> None:
        """Tail each STARTING worker's log for its ``engine_listening``
        line (incremental byte offsets — no re-reads)."""
        for h in self._engines.values():
            if h.state != STARTING or h.port is not None:
                continue
            try:
                with open(h.log_path, "rb") as f:
                    f.seek(h._log_offset)
                    chunk = f.read()
            except OSError:
                continue
            if not chunk:
                continue
            # Only complete lines advance the offset (a worker caught
            # mid-print re-scans the partial next tick).
            head, sep, _ = chunk.rpartition(b"\n")
            if not sep:
                continue
            h._log_offset += len(head) + 1
            for line in head.splitlines():
                if LISTENING_EVENT.encode() not in line:
                    continue
                try:
                    ev = json.loads(line.decode("utf-8", "replace"))
                except ValueError:
                    continue
                if ev.get("event") == LISTENING_EVENT:
                    h.port = int(ev["port"])
                    h.last_ok = time.monotonic()
                    log.info("engine %s listening on port %d",
                             h.engine_id, h.port)

    def _poll_health(self) -> None:
        with self._lock:
            targets = [(h.engine_id, h.port) for h in
                       self._engines.values()
                       if h.state in (STARTING, ALIVE)
                       and h.port is not None]
        results: dict[str, dict | None] = {}
        for engine_id, port in targets:
            client = FleetClient(self.cfg.fleet.host, port,
                                 timeout_s=self.cfg.fleet.scrape_timeout_s)
            try:
                results[engine_id] = client.health()
            except Exception:   # noqa: BLE001 — an unreachable member is
                results[engine_id] = None   # a health datum, not a fault
            finally:
                client.close()
        now = time.monotonic()
        with self._lock:
            for engine_id, health in results.items():
                h = self._engines.get(engine_id)
                if h is None or h.state not in (STARTING, ALIVE):
                    continue
                if health is not None:
                    h.health = health
                    h.last_ok = now
                    if h.state == STARTING:
                        h.state = ALIVE
                        # A respawn that answers healthz proved itself:
                        # the crash streak resets.
                        h.streak = 0

    def _enforce_timeouts(self) -> None:
        fc = self.cfg.fleet
        now = time.monotonic()
        for h in self._engines.values():
            if h.proc is None or h.proc.poll() is not None:
                continue
            if h.state == STARTING and h.port is None:
                if (fc.startup_timeout_s > 0
                        and now - h.spawned_at > fc.startup_timeout_s):
                    log.error("engine %s never reported listening within "
                              "%.0fs; killing the presumed-wedged "
                              "bring-up", h.engine_id,
                              fc.startup_timeout_s)
                    self._kill_handle(h)
            elif h.state in (STARTING, ALIVE) and h.port is not None:
                if (fc.health_timeout_s > 0 and h.last_ok
                        and now - h.last_ok > fc.health_timeout_s):
                    log.error("engine %s healthz silent %.1fs > %.1fs; "
                              "killing the presumed-wedged process",
                              h.engine_id, now - h.last_ok,
                              fc.health_timeout_s)
                    self._kill_handle(h)

    @staticmethod
    def _kill_handle(h: _EngineHandle) -> None:
        try:
            h.proc.kill()       # the next _reap classifies the crash
        except ProcessLookupError:
            pass

    def _respawn_due(self) -> None:
        if self._quiesced.is_set():
            return
        now = time.monotonic()
        for h in self._engines.values():
            if h.state == BACKOFF and now >= h.respawn_at:
                self._spawn_locked(h)

    # ---- the router's view ------------------------------------------

    def endpoints(self) -> dict[str, tuple[str, int]]:
        """``{engine_id: (host, port)}`` of every member that has
        reported a listening port and is not dead/failed — the router's
        candidate set (the router confirms liveness with its own
        scrapes)."""
        host = self.cfg.fleet.host
        with self._lock:
            return {h.engine_id: (host, h.port)
                    for h in self._engines.values()
                    if h.port is not None
                    and h.state in (STARTING, ALIVE, RETIRING)}

    def counts(self) -> dict[str, int]:
        with self._lock:
            states = [h.state for h in self._engines.values()]
        return {
            "alive": sum(s in (STARTING, ALIVE, RETIRING) for s in states),
            "backoff": sum(s == BACKOFF for s in states),
            "failed": sum(s == FAILED for s in states),
            "retired": sum(s == RETIRED for s in states),
        }

    def live_count(self) -> int:
        with self._lock:
            return sum(h.state in LIVE_STATES
                       for h in self._engines.values())

    def status(self) -> dict:
        """Membership snapshot (fleet_status.json's ``engines`` half —
        the router folds its routing view in before writing)."""
        with self._lock:
            return {
                "pid": os.getpid(),
                "started_at": self.started_at,
                "target": self.target,
                "scale_events": self.scale_events,
                "restarts_total": self.restarts_total,
                **self.counts(),
                "engines": {
                    h.engine_id: {
                        "pid": h.pid, "state": h.state, "port": h.port,
                        "restarts": h.restarts, "streak": h.streak,
                        "last_rc": h.last_rc,
                        "cpus": list(h.cpus),
                        "queue_depth": h.health.get("queue_depth"),
                        "overload": h.health.get("overload"),
                        "params_step": h.health.get("params_step"),
                        "swaps_total": h.health.get("swaps_total"),
                    } for h in self._engines.values()},
            }

    def _export_gauges(self) -> None:
        if self.registry is None:
            return
        c = self.counts()
        self.registry.record_many({
            "engines_alive": float(c["alive"]),
            "engines_failed": float(c["failed"]),
            "engines_backoff": float(c["backoff"])})

    def _write_status_locked(self) -> None:
        # The pool's own status lands inside the router's
        # fleet_status.json; standalone pools (no router) still get a
        # bare file naming every worker's pid.
        path = os.path.join(self.dir, "engine_pool.json")
        tmp = f"{path}.tmp-{os.getpid()}"
        try:
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(self.status(), f, indent=2)
            os.replace(tmp, path)
        except OSError:
            log.exception("engine-pool status write failed")

    # ---- shutdown ---------------------------------------------------

    def kill_all(self) -> None:
        """Hard-exit teardown (``os._exit`` paths): SIGKILL everything
        now — an unsupervised orphan engine would serve forever."""
        self._quiesced.set()
        with self._lock:
            for h in self._engines.values():
                if h.proc is not None and h.proc.poll() is None:
                    self._kill_handle(h)

    def stop(self, grace_s: float = 15.0) -> None:
        """Drain the fleet: SIGTERM every live engine (their own drain →
        exit 75 contract), SIGKILL stragglers past the grace."""
        self._quiesced.set()
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=grace_s)
        with self._lock:
            live = [h for h in self._engines.values()
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
                log.warning("engine %s did not drain in %.1fs; SIGKILL",
                            h.engine_id, grace_s)
                h.proc.kill()
                h.proc.wait(timeout=10)
            h.last_rc = h.proc.returncode
            h.state = RETIRED
        with self._lock:
            self._write_status_locked()
