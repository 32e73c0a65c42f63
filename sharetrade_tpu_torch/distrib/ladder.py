"""The process-supervision ladder shared by every pool of child processes.

A copy of the JAX package's ``distrib/ladder.py``: every child exit is
classified the same way — a retiring or quiesced child retires quietly,
anything else is a crash feeding seeded exponential backoff, and a streak of
consecutive crashes past the restart budget is a terminal failure the pool
degrades around instead of respawning forever. What "healthy" means and how
a child spawns stay with the pool that owns the children (the port's one
user is :class:`~sharetrade_tpu_torch.fleet.pool.EnginePool`).

The jitter draw is one ``rng.uniform(-jitter, +jitter)`` per crash, so a
seeded pool replays the same backoff schedule as the JAX package's.
"""

from __future__ import annotations

import random
from dataclasses import dataclass

#: Child lifecycle states (the status.json vocabulary, shared verbatim).
STARTING, ALIVE, BACKOFF, FAILED, RETIRING, RETIRED = (
    "starting", "alive", "backoff", "failed", "retiring", "retired")

#: States that count as LIVE membership (toward a pool's scale target).
LIVE_STATES = (STARTING, ALIVE, BACKOFF)


@dataclass(frozen=True)
class LadderPolicy:
    """The supervision knobs, pool-agnostic: how many consecutive crashes
    a child may burn before it is terminally FAILED, and the seeded
    exponential-backoff schedule between respawns."""

    max_restarts: int
    backoff_initial_s: float
    backoff_max_s: float
    backoff_jitter: float

    def validate(self, *, section: str) -> None:
        from sharetrade_tpu_torch.config import ConfigError
        if self.max_restarts < 0:
            raise ConfigError(
                f"{section} max restarts must be >= 0, got "
                f"{self.max_restarts}")
        if self.backoff_initial_s <= 0 or self.backoff_max_s <= 0:
            raise ConfigError(
                f"{section} backoff seconds must be > 0, got "
                f"{self.backoff_initial_s}/{self.backoff_max_s}")


def crash_step(streak: int, policy: LadderPolicy,
               rng: random.Random) -> tuple[str, float]:
    """One rung of the ladder, applied AFTER a crash bumped the child's
    consecutive-crash ``streak``: returns ``(next_state, respawn_delay_s)``
    — :data:`FAILED` (delay 0, the pool degrades onto survivors) once the
    streak exceeds the budget, else :data:`BACKOFF` with the seeded
    jittered exponential delay. Draws exactly one jitter sample from
    ``rng`` on the BACKOFF arm (the replayable-schedule contract)."""
    if streak > policy.max_restarts:
        return FAILED, 0.0
    delay = min(policy.backoff_initial_s * 2 ** (streak - 1),
                policy.backoff_max_s)
    delay *= 1.0 + rng.uniform(-policy.backoff_jitter,
                               policy.backoff_jitter)
    return BACKOFF, max(delay, 0.0)
