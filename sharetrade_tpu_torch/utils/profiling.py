"""Per-chunk wall-clock accounting.

The port's copy of :class:`StepTimer` from the JAX package's
``utils/profiling.py`` (that module's ``Tracer`` wraps ``jax.profiler`` and
is not ported: ``runtime.profile_dir`` stays refused). The orchestrator
ticks it once per metrics sample with the number of chunks the sample
covers; ``summary()`` is what the ``training_completed`` event carries
(``chunks_timed``, ``total_seconds``, ``mean_chunk_seconds``,
``mean_agent_steps_per_sec``).
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field


@dataclass
class StepTimer:
    """Per-chunk wall-clock accounting → steps/sec metrics."""

    chunk_steps: int
    num_agents: int
    _last: float | None = None
    # (elapsed seconds, chunks covered) per tick: the orchestrator's sampled
    # metrics cadence ticks once per SAMPLE, covering several dispatched
    # chunks, so each entry carries its own chunk count. Bounded by
    # ``max_history`` (a ring; soak runs previously grew this without
    # limit) — summary() stays EXACT under eviction via the running totals.
    history: list[tuple[float, int]] = field(default_factory=list)
    max_history: int | None = None
    _total_seconds: float = 0.0
    _total_chunks: int = 0

    def __post_init__(self) -> None:
        if self.max_history:
            self.history = deque(self.history, maxlen=int(self.max_history))

    def tick(self, chunks: int = 1) -> dict[str, float]:
        """Call once per completed chunk — or once per metrics sample with
        ``chunks`` = the number of chunks dispatched since the last tick;
        returns throughput metrics averaged over that span."""
        now = time.perf_counter()
        if self._last is None:
            self._last = now
            return {}
        dt = now - self._last
        self._last = now
        self.history.append((dt, chunks))
        self._total_seconds += dt
        self._total_chunks += chunks
        agent_steps = self.chunk_steps * self.num_agents * chunks
        return {
            "chunk_seconds": dt / chunks,
            "env_steps_per_sec":
                self.chunk_steps * chunks / dt if dt > 0 else 0.0,
            "agent_steps_per_sec": agent_steps / dt if dt > 0 else 0.0,
        }

    def rebase(self) -> None:
        """Restart the interval clock without recording anything — called
        after a supervision recovery so the failed chunk, the backoff
        sleep, and the checkpoint restore don't pollute the next sample's
        throughput metrics."""
        self._last = time.perf_counter()

    def summary(self) -> dict[str, float]:
        if not self._total_chunks:
            return {}
        # Running totals, not the (possibly ring-evicted) history: the
        # whole-run aggregates stay exact no matter how long the soak.
        total = self._total_seconds
        chunks = self._total_chunks
        return {
            "chunks_timed": float(chunks),
            "total_seconds": total,
            "mean_chunk_seconds": total / chunks,
            "mean_agent_steps_per_sec":
                self.chunk_steps * self.num_agents * chunks / total,
        }
