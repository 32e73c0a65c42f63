"""The rollout-actor process body (``cli actor``): one failure domain.

Counterpart of the JAX package's ``distrib/actor.py``. The reference's
worker actors roll out episodes against a shared learner
(TrainerRouterActor broadcasts StartTraining to ten TrainerChildActors);
here each worker is a whole OS process that:

- boots its policy weights from the learner's ``tag_best``, then its newest
  intact step checkpoint, then (loudly) a seeded fresh init, through the
  verified restore of :class:`~sharetrade_tpu_torch.checkpoint.
  CheckpointManager`, and keeps them fresh with the serving tier's
  :class:`~sharetrade_tpu_torch.serve.swap.WeightSwapWatcher`: a corrupt
  candidate is refused and the actor rolls on with its current weights;
- rolls out epsilon-greedy chunks with exactly the DQN agent's rollout half
  (``agents/dqn.explore_step``: quarantine mask, horizon freeze, epsilon ramp
  over the actor's cumulative env-step count) and no update: the learner
  owns the gradient;
- appends each chunk's valid transitions to its OWN journal
  (``<distrib.actor_dir>/<actor_id>/transitions.journal``, the packed
  records of ``data/transitions.py``, segment rotation and retirement at
  twice ``learner.replay_capacity``, one flock'd writer per journal);
- stamps a heartbeat file the supervising
  :class:`~sharetrade_tpu_torch.distrib.pool.ActorPool` reads, and drains on
  a stop (journal flush, final heartbeat; ``cli actor`` exits 75).

Stamps are the actor's cumulative env-step counter, recovered from its
journal's high-water at boot, so they stay monotone across restarts: the
learner's per-actor ingest cursor (``read_new_transitions``) relies on it.

The chunk is a :class:`~sharetrade_tpu_torch.agents.base.ChunkProgram`, as a
learner's is: on the card an eager first chunk, then one CUDA graph
captured and replayed once per chunk over static buffers; a swap or an
episode re-arm loads the new weights or env state into those buffers. Its
randomness comes from an explicit ``torch.Generator`` seeded ``seed + 101 +
crc32(actor_id) % 100003`` (+1 for the loop), as the JAX actor seeds its
key, drawn a chunk at a time through the ``draw`` seam (the epsilon-greedy
gates and random actions of ``agents/qlearn.chunk_draws``).
"""

from __future__ import annotations

import json
import os
import threading
import time
import zlib
from typing import Any, Callable

import numpy as np
import torch

from sharetrade_tpu_torch.config import ConfigError, FrameworkConfig
from sharetrade_tpu_torch.utils.logging import get_logger

log = get_logger("distrib.actor")

HEARTBEAT_FILE = "heartbeat.json"
TRANSITIONS_FILE = "transitions.journal"


def write_heartbeat(path: str, **fields: Any) -> None:
    """Atomically rewrite the actor's heartbeat stamp (wall time + rollout
    progress). A transient health stamp, not durable state: no fsync."""
    tmp = f"{path}.tmp-{os.getpid()}"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump({"time": time.time(), **fields}, f)
    os.replace(tmp, path)


def read_heartbeat(path: str) -> dict | None:
    try:
        with open(path, encoding="utf-8") as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def make_rollout_agent(model, env, lcfg, num_agents: int, chunk_steps: int,
                       precision, draw: Callable | None = None):
    """The rollout chunk as an :class:`~sharetrade_tpu_torch.agents.base.
    Agent` a chunk program runs: ``chunk_steps`` epsilon-greedy env steps
    over ``num_agents`` rows (``agents/dqn.explore_step``, no update), the
    state's ``env_steps`` advanced where any row was active. The metrics
    are the chunk-end ``env_steps`` and ``min_t``, the smallest env cursor
    (== the horizon when every row finished its episode), and the
    ``transitions``, per field a (T, B, ...) tensor. ``draw`` overrides the
    chunk's draws (default: ``agents/qlearn.chunk_draws`` from
    ``ts.rng``)."""
    from sharetrade_tpu_torch.agents.base import Agent
    from sharetrade_tpu_torch.agents.dqn import explore_step, stack_transitions
    from sharetrade_tpu_torch.agents.qlearn import chunk_draws

    if draw is None:
        def draw(ts):
            return chunk_draws(ts.rng, chunk_steps, num_agents,
                               model.num_actions, model.device)

    def step(ts, draws=None):
        if draws is None:
            draws = draw(ts)
        compute = precision.cast_compute(ts.params)
        env_state, env_steps = ts.env_state, ts.env_steps
        taken = []
        with torch.no_grad():
            for i in range(chunk_steps):
                env_state, obs, actions, rewards, next_obs, active = (
                    explore_step(model, env, compute, env_state, env_steps,
                                 draws.gate[i], draws.random_action[i],
                                 lcfg))
                taken.append((obs, actions, rewards, next_obs, active))
                env_steps = env_steps + active.any().to(torch.int32)
            metrics = {"env_steps": env_steps, "min_t": env_state.t.min(),
                       "transitions": stack_transitions(taken)}
        return ts.replace(env_state=env_state, env_steps=env_steps), metrics

    return Agent(name="rollout", init=None, step=step, num_agents=num_agents,
                 steps_per_chunk=chunk_steps, model=model, draw=draw)


class RolloutActor:
    """One rollout actor: policy forwards only, transitions out, weights
    in. Built from the config the learner runs, so the env, the model and
    the precision agree with the checkpoints it restores. ``device`` is
    ``cuda`` unless given; ``draw`` overrides the chunk's draws (a test
    seam)."""

    def __init__(self, cfg: FrameworkConfig, prices, *, actor_id: str,
                 workdir: str, device: torch.device | str | None = None,
                 draw: Callable | None = None):
        if not actor_id or not all(
                c.isalnum() or c in "-_" for c in actor_id):
            raise ConfigError(f"bad actor id {actor_id!r} "
                              "(alphanumeric/-/_ only)")
        from sharetrade_tpu_torch.agents import build_agent
        from sharetrade_tpu_torch.agents.base import ChunkProgram
        from sharetrade_tpu_torch.checkpoint import CheckpointManager
        from sharetrade_tpu_torch.data.journal import Journal
        from sharetrade_tpu_torch.data.transitions import read_tail_transitions
        from sharetrade_tpu_torch.device import resolve_device
        from sharetrade_tpu_torch.env import make_env
        from sharetrade_tpu_torch.precision import policy_from_config

        self.cfg = cfg
        self.actor_id = actor_id
        self.workdir = workdir
        self.device = resolve_device(device)
        os.makedirs(workdir, exist_ok=True)
        self.heartbeat_path = os.path.join(workdir, HEARTBEAT_FILE)
        self.env = make_env(cfg.env, prices, self.device)
        # The model the learner trains (the learner's head choice); the
        # learner's step and update are never built into a program here.
        self.model = build_agent(cfg, self.env, device=self.device).model
        self._precision = policy_from_config(cfg.precision)
        # Per-actor seed: distinct exploration streams per actor, stable
        # across restarts of the same actor id.
        self._seed = cfg.seed + 101 + (
            zlib.crc32(actor_id.encode()) % 100003)
        self._template = self.model.init(
            torch.Generator().manual_seed(self._seed))

        self.journal_path = os.path.join(workdir, TRANSITIONS_FILE)
        self._journal = Journal(
            self.journal_path,
            fsync_every_records=cfg.data.journal_fsync_every_records,
            fsync_interval_s=cfg.data.journal_fsync_interval_s,
            segment_records=cfg.data.journal_segment_records)
        # Monotone stamps: continue the env-step counter from the journal's
        # high-water, so a respawned actor never reuses a stamp.
        tail = read_tail_transitions(self.journal_path, 1,
                                     journal=self._journal)
        self._env_steps0 = int(tail[4]) if tail is not None else 0
        self._rows_since_retire = 0

        self._manager = CheckpointManager(
            cfg.runtime.checkpoint_dir, keep=cfg.runtime.keep_checkpoints,
            fsync=cfg.checkpoint.fsync, precision_mode=cfg.precision.mode)
        self.registry = None        # duck-typed for WeightSwapWatcher
        self._params_lock = threading.Lock()
        self._pending: tuple[Any, int] | None = None
        self.params, self.params_step, self._boot_meta = self._boot_params()
        self._watcher = None
        self.episodes = 0
        self.chunks = 0
        self.rows_journaled = 0
        self.swaps_applied = 0
        chunk_steps = (cfg.distrib.actor_chunk_steps
                       or cfg.runtime.chunk_steps)
        self.program = ChunkProgram(make_rollout_agent(
            self.model, self.env, cfg.learner, cfg.parallel.num_workers,
            chunk_steps, self._precision, draw=draw))

    # -- WeightSwapWatcher engine surface ------------------------------

    def swap_params(self, params, step: int) -> None:
        """Stage freshly verified weights; the rollout loop installs them
        at its next chunk boundary (no chunk mixes two sets of weights)."""
        with self._params_lock:
            self._pending = (params, int(step))

    def _boot_params(self):
        tag = "best"
        try:
            params, meta = self._manager.restore_tagged(self._template, tag)
            return (params,
                    int(meta.get("updates", meta.get("step", 0)) or 0),
                    meta)
        except FileNotFoundError:
            pass
        except Exception as exc:        # refusal-not-fatal, as in serving
            log.warning("actor %s: tag_%s boot restore refused (%s: %s); "
                        "falling back", self.actor_id, tag,
                        type(exc).__name__, exc)
        try:
            params, step = self._manager.restore(self._template)
            return params, int(step), None
        except FileNotFoundError:
            log.warning("actor %s: no checkpoint under %s; rolling out a "
                        "fresh-initialized (UNTRAINED) policy",
                        self.actor_id, self._manager.directory)
            return self._template, 0, None

    # ------------------------------------------------------------------

    def _initial_state(self):
        """The loop's first state: the reset env broadcast over the agents,
        the generator seeded ``seed + 1``, the recovered env-step count."""
        from sharetrade_tpu_torch.agents.base import TrainState, batched_reset
        device = self.device
        return TrainState(
            params=self.params, opt_state=None, carry={},
            env_state=batched_reset(self.env, self.cfg.parallel.num_workers),
            rng=torch.Generator(device=device).manual_seed(self._seed + 1),
            env_steps=torch.tensor(self._env_steps0, dtype=torch.int32,
                                   device=device),
            updates=torch.zeros((), dtype=torch.int32, device=device))

    def run(self, stop: threading.Event, *,
            max_chunks: int = 0) -> dict[str, Any]:
        """The actor loop: rollout chunk -> journal append -> heartbeat,
        until ``stop`` is set (or ``max_chunks`` chunks). Returns a summary
        dict. A rollout or journal fault propagates: the pool is the
        supervisor that restarts this process."""
        from sharetrade_tpu_torch.agents.base import batched_reset
        from sharetrade_tpu_torch.serve.swap import WeightSwapWatcher
        cfg = self.cfg
        if cfg.distrib.weight_poll_s > 0:
            self._watcher = WeightSwapWatcher(
                self, self._manager, self._template, tag="best",
                poll_s=cfg.distrib.weight_poll_s,
                seen_meta=self._boot_meta,
                breaker_failures=cfg.serve.swap_breaker_failures,
                breaker_cooldown_s=cfg.serve.swap_breaker_cooldown_s,
            ).start()
        num_agents = cfg.parallel.num_workers
        horizon = self.env.num_steps
        ts = self._initial_state()
        stamp = self._env_steps0
        hb_every = max(cfg.distrib.heartbeat_interval_s, 0.05)
        last_hb = 0.0
        self._heartbeat(env_steps=stamp, phase="starting")
        try:
            while not stop.is_set():
                with self._params_lock:
                    if self._pending is not None:
                        self.params, self.params_step = self._pending
                        self._pending = None
                        self.swaps_applied += 1
                        ts = ts.replace(params=self.params)
                ts, stacked = self.program(ts)
                readback = self.program.readback(stacked)
                row = readback.rows()[0]
                stamp = int(row["env_steps"])
                self._journal_chunk(
                    {k: v[0] for k, v in readback.transitions().items()},
                    stamp)
                self.chunks += 1
                if int(row["min_t"]) >= horizon:
                    # Every row finished its episode: re-arm a fresh one
                    # (the cumulative env_steps keeps the epsilon ramp).
                    self.episodes += 1
                    ts = ts.replace(
                        env_state=batched_reset(self.env, num_agents))
                now = time.monotonic()
                if now - last_hb >= hb_every:
                    last_hb = now
                    self._heartbeat(env_steps=stamp, phase="rolling")
                if max_chunks and self.chunks >= max_chunks:
                    break
        finally:
            if self._watcher is not None:
                self._watcher.stop()
            # Drain: every acked append durable, then the terminal stamp.
            self._journal.flush()
            self._journal.close()
            self._heartbeat(env_steps=stamp, phase="drained")
        return self.summary(stamp)

    def _journal_chunk(self, tr: dict[str, np.ndarray], stamp: int) -> None:
        """One chunk's (T, B, ...) transitions: the valid rows flattened
        (T, B) row-major and appended as one packed record stamped with the
        chunk-end env-step count."""
        from sharetrade_tpu_torch.data.transitions import (
            append_transitions, retire_transition_segments)
        valid = np.asarray(tr["valid"]).reshape(-1)
        if not valid.any():
            return
        flat = {k: np.asarray(v).reshape((-1,) + np.asarray(v).shape[2:])
                for k, v in tr.items() if k != "valid"}
        append_transitions(
            self._journal, flat["obs"][valid], flat["action"][valid],
            flat["reward"][valid], flat["next_obs"][valid], env_steps=stamp)
        n = int(valid.sum())
        self.rows_journaled += n
        self._rows_since_retire += n
        capacity = self.cfg.learner.replay_capacity
        if (self.cfg.data.journal_segment_records > 0
                and self._rows_since_retire >= capacity):
            # Bounded per-actor disk: the learner's own 2x-capacity horizon.
            retire_transition_segments(self._journal, 2 * capacity)
            self._rows_since_retire = 0

    def _heartbeat(self, *, env_steps: int, phase: str) -> None:
        write_heartbeat(
            self.heartbeat_path, pid=os.getpid(), actor_id=self.actor_id,
            env_steps=env_steps, episodes=self.episodes,
            chunks=self.chunks, rows=self.rows_journaled,
            params_step=self.params_step, phase=phase)

    def summary(self, env_steps: int) -> dict[str, Any]:
        return {
            "actor_id": self.actor_id,
            "env_steps": env_steps,
            "episodes": self.episodes,
            "chunks": self.chunks,
            "rows_journaled": self.rows_journaled,
            "params_step": self.params_step,
            "swaps_applied": self.swaps_applied,
            "swaps_rejected": (self._watcher.rejected
                               if self._watcher is not None else 0),
        }
