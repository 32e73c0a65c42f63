"""Hot weight swaps for the serving engine.

Counterpart of the JAX package's ``serve/swap.py``. A background watcher
polls the training run's tagged checkpoint (``tag_best`` by default, the
policy the orchestrator keeps for its best greedy eval) and, when it
advances, restores it through the verified path of the port's
:class:`~sharetrade_tpu_torch.checkpoint.CheckpointManager` (checksums, a
match with the template, finite params, the precision-mode check). The
restored weights go to :meth:`ServeEngine.swap_params`, which installs
them between ticks: no tick computes under two sets of weights, and every
response names the checkpoint step that produced it.

A candidate that fails verification is refused and serving goes on: the
engine keeps its weights, the refusal is counted
(``serve_swap_rejected_total``), the manager quarantines the bad copy
(never deletes it), and the watcher marks the candidate's stamp as seen so
it is not re-verified every poll. A tag the JAX package wrote (its
``state.msgpack`` layout) is passed over and left as it is: the manager
gives no metadata for it, or refuses it as foreign.

Circuit breaker: after ``serve.swap_breaker_failures`` consecutive refusals
the watcher stops polling the tag for ``serve.swap_breaker_cooldown_s``
(gauge ``serve_swap_breaker_open`` = 1, counter
``serve_swap_breaker_opens_total``), then lets one probe poll through: a
good swap closes the breaker, another refusal opens it again.
``breaker_failures=0`` disables the breaker.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable

from sharetrade_tpu_torch.checkpoint.manager import (
    CheckpointCorruptError,
    CheckpointIntegrityError,
    CheckpointManager,
    ForeignCheckpointError,
)
from sharetrade_tpu_torch.utils.logging import get_logger

log = get_logger("serve.swap")


class WeightSwapWatcher:
    """Poll ``tag_<tag>`` every ``poll_s`` seconds and hot-swap the engine.

    ``manager`` is the run's manager, or a callable that returns it once the
    checkpoint directory exists (None until then). ``template`` is what the
    checkpoint restores onto: a params tree on the serving device (the
    params alone are restored) or a ``TrainState``. ``seen_meta`` seeds the
    stamp already applied: pass the metadata of the checkpoint the engine
    booted from, so that only a newer save swaps."""

    def __init__(self, engine: Any,
                 manager: CheckpointManager | Callable[
                     [], CheckpointManager | None],
                 template: Any, *, tag: str = "best",
                 poll_s: float = 5.0, seen_meta: dict | None = None,
                 breaker_failures: int = 0,
                 breaker_cooldown_s: float = 30.0):
        self._engine = engine
        self._manager = manager
        self._template = template
        self._tag = tag
        self._poll_s = max(float(poll_s), 0.05)
        self._seen = self._stamp(seen_meta)
        self._stop = threading.Event()
        self.swaps = 0
        self.rejected = 0
        self._breaker_failures = max(int(breaker_failures), 0)
        self._breaker_cooldown_s = max(float(breaker_cooldown_s), 0.0)
        self._fail_streak = 0
        self._open_until = 0.0          # monotonic; 0 = closed
        self.breaker_opens = 0
        self._thread = threading.Thread(target=self._loop,
                                        name="serve-swap-watcher",
                                        daemon=True)

    @staticmethod
    def _stamp(meta: dict | None):
        if not meta:
            return None
        return (meta.get("saved_at"), meta.get("updates"), meta.get("step"))

    def start(self) -> "WeightSwapWatcher":
        self._thread.start()
        return self

    def stop(self, timeout_s: float = 10.0) -> None:
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout_s)

    @property
    def breaker_open(self) -> bool:
        """True while the circuit breaker holds polls off the tag."""
        return self._open_until > 0.0 and time.monotonic() < self._open_until

    def poll_once(self) -> bool:
        """One poll: True when a swap was applied."""
        registry = getattr(self._engine, "registry", None)
        if self._open_until > 0.0:
            if time.monotonic() < self._open_until:
                return False        # open: the wedged tag is not polled
            # Cooldown over, half-open: one probe goes through (a refusal
            # in _reject opens the breaker again).
            self._open_until = 0.0
            if registry is not None:
                registry.record("serve_swap_breaker_open", 0.0)
            log.info("hot-swap breaker half-open: probing tag %r",
                     self._tag)
        manager = self._manager
        if not isinstance(manager, CheckpointManager):
            manager = manager()
            if manager is None:
                return False        # no checkpoint directory yet
            self._manager = manager
        meta = manager.tagged_metadata(self._tag)
        stamp = self._stamp(meta)
        if stamp is None or stamp == self._seen:
            return False
        try:
            state, restored_meta = manager.restore_tagged(
                self._template, self._tag)
        except CheckpointCorruptError as exc:
            # The tag and its .old copy both failed verification.
            self._reject(stamp, registry, exc)
            return False
        except FileNotFoundError:
            return False            # no tag yet (or quarantined away)
        except ForeignCheckpointError as exc:
            # A tag of the JAX package: passed over and left as it is.
            self._seen = stamp
            log.warning("hot-swap passes over tag %r: %s", self._tag, exc)
            return False
        except (CheckpointIntegrityError, ValueError) as exc:
            # ValueError: intact bytes that do not fit this run (another
            # model, a precision-mode mismatch).
            self._reject(stamp, registry, exc)
            return False
        step = restored_meta.get("updates", restored_meta.get("step", 0))
        self._engine.swap_params(getattr(state, "params", state), int(step))
        self._seen = self._stamp(restored_meta)
        self.swaps += 1
        self._fail_streak = 0           # a good candidate heals the breaker
        if registry is not None:
            registry.record("serve_swap_breaker_open", 0.0)
        return True

    def _reject(self, stamp, registry, exc: BaseException) -> None:
        self.rejected += 1
        self._seen = stamp
        if registry is not None:
            registry.inc("serve_swap_rejected_total")
        log.warning("hot-swap candidate %r refused; serving continues on "
                    "step %d (%s: %s)", self._tag,
                    getattr(self._engine, "params_step", -1),
                    type(exc).__name__, exc)
        self._fail_streak += 1
        if (self._breaker_failures > 0
                and self._fail_streak >= self._breaker_failures):
            # The streak is not reset here: a refused half-open probe stays
            # past the threshold and opens the breaker again at once.
            self._open_until = time.monotonic() + self._breaker_cooldown_s
            self.breaker_opens += 1
            if registry is not None:
                registry.record("serve_swap_breaker_open", 1.0)
                registry.inc("serve_swap_breaker_opens_total")
            log.error(
                "hot-swap circuit breaker OPEN: %d consecutive refused "
                "candidates on tag %r; not polling for %.1fs",
                self._breaker_failures, self._tag,
                self._breaker_cooldown_s)

    def _loop(self) -> None:
        while not self._stop.wait(self._poll_s):
            try:
                self.poll_once()
            except Exception:       # noqa: BLE001 — the watcher outlives
                # any single bad poll.
                log.exception("hot-swap poll failed; serving continues")
