"""The train -> serve -> train flywheel's client half: served sessions
journal their observed transitions.

Counterpart of the JAX package's ``fleet/flywheel.py``. Production traffic
becomes training data through the data plane the rollout actors use (the
framed journal of ``data/journal.py``, the packed records of
``data/transitions.py``, the learner's feed ingest): a load source wraps
its sessions in :class:`JournalingSession`, whose every served action lands
one ``(obs, action, reward, next_obs)`` row, the reward being the session's
own portfolio-value change (the env's reward), in a
:class:`SessionTransitionJournal` under ``distrib.actor_dir/<writer_id>/``,
stamped with a monotone per-writer row counter recovered from the
journal's tail at boot (a restart never reuses a stamp).

The learner half is ``Orchestrator.ingest_actor_feeds``, which re-discovers
the journal set each tick, so a session journal is an actor journal to the
learner (``distrib.ingest_without_pool`` opens the gate with no actor pool
in the learner's process; ``cli fleet --learner``). The loop closes through
the weight path: the learner republishes ``tag_best``, every engine's swap
watcher hot-swaps it in, and every response's ``params_step`` names the
checkpoint that produced it.

The reward is computed in Python floats from the session's budget, share
count and float32 prices, as the JAX session computes it, so a journal of
either package holds the same rows for the same served actions wherever the
two sessions' budgets agree (the port's session keeps its budget in float32,
as the env does).
"""

from __future__ import annotations

import os
import threading

import numpy as np

from sharetrade_tpu_torch.distrib.actor import TRANSITIONS_FILE
from sharetrade_tpu_torch.serve.driver import SessionSim
from sharetrade_tpu_torch.utils.logging import get_logger

log = get_logger("fleet.flywheel")


class SessionTransitionJournal:
    """One writer's transitions journal under the learner's ingest root.

    Thread-safe: many session callbacks append concurrently; rows buffer in
    memory and commit as one framed record per ``flush_rows`` rows. Stamps
    are a monotone cumulative row counter per writer, recovered from the
    journal's tail at construction (the ``distrib/actor.py`` contract)."""

    def __init__(self, root: str, writer_id: str, *, obs_dim: int,
                 flush_rows: int = 64, segment_records: int = 256,
                 fsync_every_records: int = 64,
                 fsync_interval_s: float = 0.5):
        from sharetrade_tpu_torch.data.journal import Journal
        from sharetrade_tpu_torch.data.transitions import read_tail_transitions
        self.workdir = os.path.join(root, writer_id)
        os.makedirs(self.workdir, exist_ok=True)
        self.path = os.path.join(self.workdir, TRANSITIONS_FILE)
        self._journal = Journal(
            self.path, fsync_every_records=fsync_every_records,
            fsync_interval_s=fsync_interval_s,
            segment_records=segment_records)
        self.obs_dim = int(obs_dim)
        self.flush_rows = max(1, int(flush_rows))
        tail = read_tail_transitions(self.path, 1, journal=self._journal)
        self._stamp = int(tail[4]) if tail is not None else 0
        self.rows_journaled = 0
        self._buf: list[tuple] = []
        self._lock = threading.Lock()

    def record(self, obs, action: int, reward: float, next_obs) -> None:
        obs = np.asarray(obs, np.float32)
        next_obs = np.asarray(next_obs, np.float32)
        if obs.shape != (self.obs_dim,) or next_obs.shape != obs.shape:
            # Fail at the writer, not two processes later when the
            # learner's ingest refuses the whole journal.
            raise ValueError(
                f"transition obs shape {obs.shape}/{next_obs.shape} != "
                f"the journal's obs_dim ({self.obs_dim},): is the "
                "session's window the learner's env window?")
        with self._lock:
            self._buf.append((obs, int(action), float(reward), next_obs))
            if len(self._buf) >= self.flush_rows:
                self._flush_locked()

    def flush(self) -> None:
        with self._lock:
            self._flush_locked()
            self._journal.flush()

    def _flush_locked(self) -> None:
        if not self._buf:
            return
        from sharetrade_tpu_torch.data.transitions import append_transitions
        rows, self._buf = self._buf, []
        obs = np.stack([r[0] for r in rows])
        action = np.asarray([r[1] for r in rows], np.int32)
        reward = np.asarray([r[2] for r in rows], np.float32)
        next_obs = np.stack([r[3] for r in rows])
        self._stamp += len(rows)
        append_transitions(self._journal, obs, action, reward, next_obs,
                           env_steps=self._stamp)
        self.rows_journaled += len(rows)

    def close(self) -> None:
        self.flush()
        self._journal.close()


class JournalingSession(SessionSim):
    """A served session that journals what it observes: each
    :meth:`advance` computes the portfolio-value reward of the action it
    was served, captures the before and after observations, and records
    the transition. The observation is the learner env's exactly (window
    prices, budget, shares); the ingest refuses another width loudly."""

    def __init__(self, *args, journal: SessionTransitionJournal
                 | None = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.journal = journal

    def _value(self) -> float:
        prices = self._grid[:, self.start + self.t + self.window]
        return float(self.budget) + sum(
            float(s) * float(p) for s, p in zip(self.shares, prices))

    def advance(self, action: int) -> None:
        if self.journal is None:
            super().advance(action)
            return
        obs_t = self.observation()
        value_before = self._value()
        gen = self.generation
        super().advance(action)
        if self.generation != gen:
            # The episode wrapped: the fresh episode's first observation
            # is not this transition's successor, so the boundary row is
            # skipped (the journal has no done flag).
            return
        self.journal.record(obs_t, action, self._value() - value_before,
                            self.observation())


def make_journaling_sessions(prices, window: int, n: int, *,
                             journal: SessionTransitionJournal,
                             seed: int = 0,
                             prefix: str = "fs") -> list[JournalingSession]:
    """``n`` journaling sessions with staggered starts (the
    ``make_sessions`` shape, flywheel-wired)."""
    prices = np.asarray(prices, np.float32)
    horizon = prices.shape[-1] - window - 1
    if horizon < 1:
        raise ValueError(f"price series too short for window={window}")
    rng = np.random.default_rng(seed)
    starts = rng.integers(0, max(horizon - 1, 1), size=n)
    return [JournalingSession(f"{prefix}{i}", prices, window, starts[i],
                              journal=journal)
            for i in range(n)]
