"""The training orchestrator: the lifecycle protocol around a supervised
chunk loop.

Counterpart of the JAX package's ``runtime/orchestrator.py``:

- the lifecycle FSM (awaiting-data -> ready -> training -> trained/
  completed), with StartTraining stashed until data arrives;
- the loop: each chunk is one ``agent.step`` (``runtime.chunk_steps`` env
  steps for the whole agent batch and the learner's updates), its metrics
  read
  back ONCE as one stacked tensor, the snapshot that
  ``get_avg``/``get_std``/``snapshot`` answer from replaced;
- the episode gate: an episode completes when the cumulative env-step count
  reaches ``(episode + 1) x horizon`` and every agent's cursor has reached
  the horizon; the run re-arms (fresh env state and carry, learned params
  kept) until ``runtime.episodes`` are done, and writes a final checkpoint;
- supervision: a failing chunk goes through ``error_policy`` (exception
  type -> RESUME / RESTART / STOP / ESCALATE). RESTART waits an exponential
  backoff (``backoff_initial_s`` doubling up to ``backoff_max_s``, with
  ``backoff_jitter``), then restores the latest intact checkpoint or, with
  none, re-initialises; past ``max_restarts`` the run ends FAILED;
- per-agent heals (``partial_recovery``): a non-finite agent row is
  respawned in place, at the survivors' cursor with the representative
  row's carry, up to ``max_agent_heals`` times; shared state that is not
  finite, every row bad, or no row bad falls back to the restart path;
- checkpoints (``checkpoint/manager.py``): a baseline before the first chunk
  and one every ``checkpoint_every_updates`` updates, both ``save_async``;
- preemption: :meth:`request_preempt` stops the loop at the next chunk
  boundary and writes the ``tag_preempt`` checkpoint inside
  ``runtime.preempt_grace_s`` (``cli train`` maps it to exit code 75), and
  ``send_training_data(..., resume=True)`` continues from it or from the
  newest intact step checkpoint;
- greedy evaluation (:meth:`evaluate`, :meth:`evaluate_best`, every
  ``eval_every_updates``): one argmax replay of the episode in the compute
  precision (through the precomputed trunk where the model has one, else
  step by step); under ``keep_best_eval`` the best policy so far is
  ``tag_best``.

Test seams as in the JAX package: ``step_override`` replaces the agent's
step, ``fault_hook(chunk_idx, row)`` runs on every chunk's metrics row.

Not yet ported: the async readback pipeline, megachunks, sampled metric
readback, roofline/obs, the DQN transition journal, actor feeds and warm
starts. A
non-default value of such a knob raises ``ConfigError``; where the default
itself turns the feature on, the run goes on and logs one warning line
naming what it does instead (:func:`check_ported`).
"""

from __future__ import annotations

import dataclasses
import random
import threading
import time
from typing import Any, Callable

import numpy as np
import torch

from sharetrade_tpu_torch.agents import build_agent
from sharetrade_tpu_torch.agents.base import (
    Agent, TrainState, agent_health, build_optimizer, election_health)
from sharetrade_tpu_torch.agents.rollout import (
    greedy_rollout, greedy_rollout_precomputed, supports_precomputed_trunk)
from sharetrade_tpu_torch.checkpoint import CheckpointManager
from sharetrade_tpu_torch.config import ConfigError, FrameworkConfig
from sharetrade_tpu_torch.device import resolve_device
from sharetrade_tpu_torch.env.trading import make_trading_env
from sharetrade_tpu_torch.models.core import tree_leaves
from sharetrade_tpu_torch.precision import policy_from_config
from sharetrade_tpu_torch.runtime.lifecycle import (
    Lifecycle, Phase, QueryReply, ReplyState)
from sharetrade_tpu_torch.utils.logging import EventLog, get_logger

log = get_logger("runtime.orchestrator")

#: Supervision verbs.
RESUME, RESTART, STOP, ESCALATE = "resume", "restart", "stop", "escalate"

#: The default decider, as in the JAX package: a config error can never
#: heal (STOP), an arithmetic error keeps the state (RESUME), and anything
#: else restarts from the latest checkpoint.
DEFAULT_ERROR_POLICY: dict[type, str] = {
    ArithmeticError: RESUME,
    AttributeError: RESTART,
    ConfigError: STOP,
    KeyboardInterrupt: ESCALATE,
}

#: Knobs whose feature is not ported, with the default the port runs at:
#: any other value is refused.
_REFUSED = {
    "runtime.megachunk_factor": 1,
    "runtime.double_buffer_dispatch": False,
    "runtime.pipeline_depth": 2,
    "runtime.profile_dir": None,
    "obs.enabled": False,
    "distrib.num_actors": 0,
    "tuning.profile": None,
}

#: Knobs whose DEFAULT turns on a feature that is not ported: the run goes
#: on, does what the message says, and says so once.
_WARNED = {
    "runtime.async_pipeline":
        (lambda v: bool(v), "the async readback pipeline (metrics are read "
                            "back synchronously, once per chunk)"),
    "runtime.metrics_every_chunks":
        (lambda v: v != 1, "sampled metric readback (every chunk is read "
                           "back)"),
}


def _knob(cfg: FrameworkConfig, path: str) -> Any:
    section, key = path.split(".")
    return getattr(getattr(cfg, section), key)


def check_ported(cfg: FrameworkConfig) -> list[str]:
    """Raise ``ConfigError`` for a non-default value of an unported knob;
    return the unported features the config's defaults turn on."""
    for path, default in _REFUSED.items():
        value = _knob(cfg, path)
        if value != default:
            raise ConfigError(f"{path}={value!r} is not yet ported to "
                              "sharetrade_tpu_torch")
    if cfg.parallel.mesh_shape:
        raise ConfigError("parallel.mesh_shape: multi-device layouts are not "
                          "yet ported to sharetrade_tpu_torch")
    return [f"{what} [{path}]" for path, (on, what) in _WARNED.items()
            if on(_knob(cfg, path))]


def _clone(tree):
    """A copy of a tree of tensors (dicts, lists, tuples, named tuples and
    dataclasses) that owns every tensor."""
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(_clone(v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_clone(v) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return type(tree)(**{f.name: _clone(getattr(tree, f.name))
                             for f in dataclasses.fields(tree)})
    return tree


def _clone_state(ts: TrainState) -> TrainState:
    """A copy that owns its tensors and generator (the step updates the
    parameters, moments and DQN's replay in place)."""
    rng = ts.rng
    if isinstance(rng, torch.Generator):
        rng = torch.Generator(device=rng.device)
        rng.set_state(ts.rng.get_state())
    return _clone(ts).replace(rng=rng)


class Orchestrator:
    """Owns the env, the agent and the training state of one run; drives
    the supervised chunk loop on a background thread (or inline)."""

    def __init__(self, cfg: FrameworkConfig, *,
                 device: torch.device | str | None = None,
                 checkpoints: CheckpointManager | None = None,
                 event_log: EventLog | None = None,
                 step_override: Callable[[TrainState], tuple[TrainState,
                                                              dict]] | None = None,
                 fault_hook: Callable[[int, dict], None] | None = None,
                 error_policy: dict[type, str] | None = None):
        unported = check_ported(cfg)
        if unported:
            log.warning("not yet ported, running without: %s",
                        "; ".join(unported))
        self.cfg = cfg
        self.device = resolve_device(device)
        self.lifecycle = Lifecycle()
        self._precision = policy_from_config(cfg.precision)
        self.checkpoints = checkpoints or CheckpointManager(
            cfg.runtime.checkpoint_dir, keep=cfg.runtime.keep_checkpoints,
            fsync=cfg.checkpoint.fsync, precision_mode=cfg.precision.mode)
        if getattr(self.checkpoints, "precision_mode", None) is None:
            self.checkpoints.precision_mode = cfg.precision.mode
        self.events = event_log or EventLog(None)
        self._step_override = step_override
        self._fault_hook = fault_hook
        self._error_policy = (DEFAULT_ERROR_POLICY if error_policy is None
                              else error_policy)
        self.agent: Agent | None = None
        self.env = None
        self._ts: TrainState | None = None
        self._snapshot: dict[str, float] = {}
        self._snapshot_lock = threading.Lock()
        # Held across each step call: a reader that copies the state under
        # it sees a chunk boundary, never a half-applied update.
        self._step_lock = threading.RLock()
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        self._preempt = threading.Event()
        self._preempt_deadline: float | None = None
        self.preempted = False
        #: Whether the preemption drain published ``tag_preempt``.
        self.preempt_saved = False
        self.restarts = 0
        self.agent_heals = 0
        self._best_eval: float | None = None   # seeded from tag_best
        self._best_eval_lock = threading.Lock()
        self._last_ckpt_updates = 0
        self.episode = 0
        self.chunks = 0
        self.last_error: BaseException | None = None

    # ---- protocol: SendTrainingData ------------------------------------

    def send_training_data(self, prices, *, resume: bool = False,
                           train_state: TrainState | None = None,
                           params: Any = None) -> None:
        """Build the env and the agent from a 1-D price series. The state
        is the latest checkpoint with ``resume`` (``tag_preempt`` when it is
        at least as new as the newest intact step; ``FileNotFoundError``
        when there is none), ``train_state`` (a converted JAX state or a
        ``.npz`` one, ``convert.py``), a seeded init with ``params`` in
        place of its weights (the optimizer state started fresh; DQN's
        target network a copy of them), or a seeded init."""
        prices = np.asarray(prices)
        if prices.ndim == 2 and prices.shape[0] > 1:
            raise ConfigError("multi-asset portfolios are not yet ported to "
                              "sharetrade_tpu_torch")
        env_cfg = self.cfg.env
        self.env = make_trading_env(
            prices.reshape(-1), window=env_cfg.window,
            initial_budget=env_cfg.initial_budget,
            initial_shares=env_cfg.initial_shares, device=self.device)
        self.agent = build_agent(self.cfg, self.env, device=self.device)
        template = self.agent.init(self.cfg.seed)
        self.episode = 0
        if resume:
            self._resume(template)
        elif train_state is not None:
            self._ts = self._adopt(train_state)
        else:
            self._ts = template
            if params is not None:
                self._ts = self._ts.replace(
                    params=params,
                    opt_state=build_optimizer(self.cfg.learner).init(params))
                if hasattr(template.extras, "target_params"):
                    # DQN's target network starts from the given weights.
                    self._ts.extras.target_params = _clone(params)
        self.lifecycle.to(Phase.READY)
        self.events.emit("training_data_received",
                         episode_steps=self.env.num_steps)
        if self.lifecycle.start_requested:
            self.lifecycle.start_requested = False
            self.start_training(
                background=getattr(self, "_stashed_background", True))

    def _resume(self, template: TrainState) -> None:
        """Adopt the resume checkpoint and recover the episode index; a
        completed episode resumed with more episodes to go re-arms."""
        state, step, saved_meta = self._restore_for_resume(template)
        horizon = self.env.num_steps
        self._ts = self._adopt(state)
        # The index rides the metadata (heals inflate env_steps past
        # horizon-per-episode); clamp to episodes-1: the final checkpoint
        # of a completed run is written after the counter moved past it.
        saved_episode = saved_meta.get("episode")
        raw = (int(saved_episode) if saved_episode is not None
               else int(state.env_steps) // horizon)
        self.episode = max(0, min(raw, self.cfg.runtime.episodes - 1))
        ok = agent_health(state.env_state).cpu().numpy()
        t = state.env_state.t.cpu().numpy()
        # Healthy cursors only; every row stranded counts as done too.
        done_cursors = not bool(ok.any()) or int(np.min(t[ok])) >= horizon
        if done_cursors and int(state.env_steps) < (self.episode + 1) * horizon:
            log.info("resumed a %s with episodes=%d; re-arming episode %d",
                     "completed episode" if ok.any()
                     else "checkpoint with every row stranded "
                          "(mid-episode progress discarded)",
                     self.cfg.runtime.episodes, self.episode)
            self._reset_episode()
        log.info("resumed from checkpoint step=%d (env cursor %d, %d "
                 "updates, episode %d)", step, int(state.env_state.t[0]),
                 int(state.updates), self.episode)
        self.events.emit("resumed", step=step)

    def _adopt(self, ts: TrainState) -> TrainState:
        """Check a handed-in state against the run's shapes; cast its carry
        to the compute dtype."""
        workers = self.cfg.parallel.num_workers
        rows = ts.env_state.t.shape[0]
        if rows != workers:
            raise ConfigError(f"the training state holds {rows} agents; "
                              f"parallel.num_workers is {workers}")
        cursor = int(ts.env_state.t.max())
        if cursor > self.env.num_steps:
            raise ValueError(f"training state env cursor ({cursor}) exceeds "
                             f"the series horizon ({self.env.num_steps}); "
                             "resume needs the same or a longer price series")
        return ts.replace(carry=self._precision.cast_carry(
            ts.carry, self.agent.model))

    # ---- protocol: StartTraining / Initialise ----------------------------

    def start_training(self, *, background: bool = True) -> None:
        if self.lifecycle.phase is Phase.AWAITING_DATA:
            self.lifecycle.start_requested = True   # stashed until data
            self._stashed_background = background
            log.info("StartTraining stashed until training data arrives")
            return
        if self.lifecycle.phase not in (Phase.READY, Phase.COMPLETED,
                                        Phase.TRAINED, Phase.FAILED):
            log.info("already training; ignoring StartTraining")
            return
        if self.lifecycle.phase is not Phase.READY:
            self.initialise()
        self.lifecycle.to(Phase.TRAINING)
        self._stop.clear()
        if background:
            self._thread = threading.Thread(target=self._run_supervised,
                                            name="trainer", daemon=True)
            self._thread.start()
        else:
            self._run_supervised()

    def initialise(self) -> None:
        """Re-arm for a fresh episode keeping learned parameters."""
        if self.agent is None or self._ts is None:
            return
        self._reset_episode()
        self.lifecycle.to(Phase.READY)

    def _reset_episode(self) -> None:
        """Fresh env cursors, carry and generator for the next episode;
        params, optimizer state, updates, the cumulative env-step count (the
        exploration ramp's input) and the learner's extras carry over."""
        fresh = self.agent.init(self.cfg.seed + self.episode)
        self._ts = fresh.replace(
            params=self._ts.params, opt_state=self._ts.opt_state,
            updates=self._ts.updates, env_steps=self._ts.env_steps,
            # DQN keeps its replay and target network across episodes.
            extras=self._ts.extras)

    # ---- the supervised chunk loop ---------------------------------------

    @staticmethod
    def _read_metrics(metrics: dict[str, Any]) -> dict[str, float]:
        """One device-to-host read for the whole chunk's tensor metrics
        (a ``step_override`` may return plain numbers)."""
        keys = [k for k, v in metrics.items() if isinstance(v, torch.Tensor)]
        row = {k: float(v) for k, v in metrics.items() if k not in keys}
        if keys:
            stacked = torch.stack([metrics[k].detach().to(torch.float64)
                                   .reshape(()) for k in keys]).cpu()
            row.update(zip(keys, stacked.tolist()))
        return {k: row[k] for k in metrics}

    def _host_process(self, chunk_idx: int, metrics: dict[str, Any],
                      t0: float) -> dict[str, float]:
        """Readback, the fault hook, then the snapshot."""
        row = self._read_metrics(metrics)
        row["chunk_seconds"] = time.perf_counter() - t0
        if self._fault_hook is not None:
            self._fault_hook(chunk_idx, row)
        self.chunks += 1
        with self._snapshot_lock:
            self._snapshot = row
        return row

    def _run_supervised(self) -> None:
        rt = self.cfg.runtime
        horizon = self.env.num_steps
        step_fn = self._step_override or self.agent.step
        chunk_idx = 0
        self._last_ckpt_updates = 0
        # Baseline before the first chunk unless an INTACT checkpoint could
        # already serve a restore: "lose at most checkpoint_every_updates
        # updates" holds from chunk 0.
        if rt.checkpoint_every_updates > 0 and not self.checkpoints.any_intact():
            self.checkpoints.save_async(
                int(self._ts.updates), self._ts,
                metadata={"episode": self.episode,
                          "env_steps": int(self._ts.env_steps)})
        while not self._stop.is_set():
            in_step = False
            try:
                if self._preempt.is_set():
                    self._preempt_shutdown()
                    return
                t0 = time.perf_counter()
                with self._step_lock:
                    in_step = True
                    self._ts, metrics = step_fn(self._ts)
                    in_step = False
                row = self._host_process(chunk_idx, metrics, t0)
                chunk_idx += 1
                if self._boundary_actions(row, horizon) == "completed":
                    return
            except Exception as exc:  # the supervision decider
                self.last_error = exc
                verb = self._decide(exc)
                self.events.emit("worker_failed", error=repr(exc), verb=verb,
                                 restarts=self.restarts + 1)
                if verb == RESUME:
                    log.warning("resuming after %r (policy: resume)", exc)
                    if in_step:
                        # The step updates the parameters in place: a fault
                        # inside it leaves no state to resume from.
                        log.warning("the failed step may have updated the "
                                    "state in place; restoring")
                        self._restore_or_reinit()
                    continue
                if verb == STOP:
                    self.lifecycle.force(Phase.FAILED)
                    log.error("stopping after %r (policy: stop)", exc)
                    return
                if verb == ESCALATE:
                    self.lifecycle.force(Phase.FAILED)
                    raise
                self.restarts += 1
                if self.restarts > rt.max_restarts:
                    self.lifecycle.force(Phase.FAILED)
                    log.error("restart budget exhausted: %r", exc)
                    return
                delay = min(rt.backoff_initial_s * 2 ** (self.restarts - 1),
                            rt.backoff_max_s)
                delay *= 1.0 + random.uniform(-rt.backoff_jitter,
                                              rt.backoff_jitter)
                log.warning("chunk failed (%r); restart %d/%d in %.2fs",
                            exc, self.restarts, rt.max_restarts, delay)
                if self._wait_backoff(delay):
                    return
                self._restore_or_reinit()

    def _boundary_actions(self, metrics: dict[str, float],
                          horizon: int) -> str | None:
        """Decisions on a chunk's row: per-agent heals, NaN supervision
        (raises feed the decider), eval and checkpoint cadence, and the
        episode gate. Returns "completed", "rearmed" or None."""
        rt = self.cfg.runtime
        workers = self.cfg.parallel.num_workers
        if rt.partial_recovery and metrics.get("unhealthy_workers", 0) > 0:
            # Respawn just the bad rows; past the heal budget, or beyond a
            # row respawn, the restart path takes over.
            if (self.agent_heals >= rt.max_agent_heals
                    or not self._heal_agents()):
                raise RuntimeError(
                    f"{int(metrics['unhealthy_workers'])} agent(s) "
                    "non-finite and beyond row respawn "
                    f"(heals used: {self.agent_heals}/{rt.max_agent_heals})")
        if rt.partial_recovery and not np.isfinite(metrics.get("loss", 0.0)):
            raise RuntimeError("non-finite training loss "
                               "(shared state poisoned)")

        updates = int(metrics.get("updates", 0))
        if (rt.eval_every_updates > 0
                and updates // rt.eval_every_updates
                > self._last_ckpt_updates // rt.eval_every_updates):
            # An eval or retention failure is an observability loss, not a
            # training fault.
            try:
                self.evaluate()
            except Exception:
                log.exception("periodic evaluation failed; training "
                              "continues")
        if (rt.checkpoint_every_updates > 0
                and updates // rt.checkpoint_every_updates
                > self._last_ckpt_updates // rt.checkpoint_every_updates):
            self.checkpoints.save_async(
                updates, self._ts,
                metadata={"episode": self.episode,
                          "env_steps": int(metrics.get("env_steps", 0))})
            self.events.emit("checkpoint", updates=updates)
        self._last_ckpt_updates = updates

        done_steps = (int(metrics.get("env_steps", 0))
                      >= horizon * (self.episode + 1))
        # Without heals a quarantined row can never finish: it counts as
        # excluded, like a dead child nobody respawns.
        stranded = (0.0 if rt.partial_recovery
                    else metrics.get("unhealthy_workers", 0.0))
        all_trained = (metrics.get("trained_workers", float(workers))
                       + stranded >= workers)
        if done_steps and all_trained:
            self.episode += 1
            if self.episode < rt.episodes:
                self.events.emit("episode_completed", episode=self.episode)
                log.info("episode %d completed; re-arming", self.episode)
                self._reset_episode()
                return "rearmed"
            self.checkpoints.wait_pending(timeout=60)
            self.checkpoints.save(
                updates, self._ts,
                metadata={"episode": self.episode,
                          "env_steps": int(metrics.get("env_steps", 0))})
            self.lifecycle.to(Phase.TRAINED)
            self.lifecycle.to(Phase.COMPLETED)
            self.events.emit("training_completed",
                             env_steps=int(metrics["env_steps"]),
                             episodes=self.episode)
            log.info("training completed at %d env steps",
                     int(metrics["env_steps"]))
            return "completed"
        if (not rt.partial_recovery
                and metrics.get("unhealthy_workers", 0) >= workers):
            raise RuntimeError(
                "all agent rows non-finite (partial_recovery off); no "
                "further progress is possible")
        return None

    def _decide(self, exc: BaseException) -> str:
        for etype, verb in self._error_policy.items():
            if isinstance(exc, etype):
                return verb
        return RESTART

    def _heal_agents(self) -> bool:
        """Respawn poisoned agent ROWS in place (the reference's one-dead-
        child heal). The learners' quarantine kept a non-finite row out of
        the shared parameters, so recovery is local: fresh env cursor and
        carry in the bad rows, everything else untouched.

        Trunk-rollout models share one representative's price windows and
        carry across the batch, so a respawned row rejoins AT the
        survivors' cursor: a fresh wallet at the representative's cursor,
        with the representative's carry (action-independent, so identical
        on every lockstep row).

        Returns False (the caller falls back to a restore) when the shared
        params or optimizer state are not finite, every row is bad, or no
        row is."""
        if self._step_override is not None or self.agent is None:
            return False
        ts = self._ts
        ok = election_health(ts.env_state, ts.carry).cpu().numpy()
        bad = ~ok
        if not bad.any() or bad.all():
            return False
        shared = tree_leaves(ts.params) + tree_leaves(ts.opt_state)
        if not all(bool(torch.isfinite(leaf).all()) for leaf in shared
                   if isinstance(leaf, torch.Tensor)
                   and leaf.is_floating_point()):
            return False
        fresh = self.agent.init(self.cfg.seed + 7919 * (self.agent_heals + 1))
        mask = torch.from_numpy(bad).to(ts.env_state.t.device)

        def splice(cur, new):
            m = mask.reshape((-1,) + (1,) * (cur.ndim - 1))
            return torch.where(m, new.to(cur.dtype), cur)

        fresh_env, fresh_carry = fresh.env_state, fresh.carry
        if self.agent.model.apply_rollout_trunk is not None:
            rep = int(np.flatnonzero(ok)[0])
            fresh_env = fresh_env.replace(
                t=ts.env_state.t[rep].expand(fresh_env.t.shape))
            fresh_carry = {k: c[rep:rep + 1].expand(c.shape)
                           for k, c in ts.carry.items()}
        self._ts = ts.replace(
            env_state=type(ts.env_state)(*[
                splice(c, n) for c, n in zip(ts.env_state.leaves(),
                                             fresh_env.leaves())]),
            carry={k: splice(ts.carry[k], fresh_carry[k]) for k in ts.carry})
        self.agent_heals += 1
        idx = [int(i) for i in np.flatnonzero(bad)]
        log.warning("respawned poisoned agent row(s) %s in place (heal %d; "
                    "params untouched)", idx, self.agent_heals)
        self.events.emit("agents_healed", agents=idx, heals=self.agent_heals)
        return True

    def _restore_or_reinit(self) -> None:
        """Restore the latest INTACT checkpoint (the manager verifies,
        quarantines and walks back), else re-initialise. "All corrupt" is a
        ``FileNotFoundError`` and lands on the re-init arm too."""
        template = self.agent.init(self.cfg.seed)
        self.checkpoints.wait_pending(timeout=60)
        try:
            state, step = self.checkpoints.restore(template)
            self._surface_restore_fallback()
            self._ts = state
            self.events.emit("restored", step=step)
        except FileNotFoundError:
            self._ts = template
            self.events.emit("reinitialized")

    def _surface_restore_fallback(self) -> None:
        report = self.checkpoints.last_restore_report or {}
        skipped = report.get("skipped")
        if skipped:
            self.events.emit(
                "restore_fallback", step=report.get("step"),
                skipped=[[int(s), reason] for s, reason in skipped])

    def _restore_for_resume(self, template: TrainState
                            ) -> tuple[TrainState, int, dict]:
        """``--resume`` source selection: ``tag_preempt`` when it is at
        least as new (by update count) as the newest verified step
        checkpoint, else the verified step walk-back; an intact
        ``tag_preempt`` is re-preferred when the walk-back lands below it,
        and serves when every step is gone or corrupt. Returns ``(state,
        step_label, metadata)``."""
        pmeta = self.checkpoints.tagged_metadata("preempt")
        tag_hint = int(pmeta.get("updates", -1)) if pmeta else -1
        latest = self.checkpoints.latest_step()

        def tag_candidate():
            try:
                state, meta = self.checkpoints.restore_tagged(
                    template, "preempt")
            except FileNotFoundError:
                return None
            return state, int(meta.get("updates", 0)), meta

        def accept(t):
            log.info("resuming from preemption checkpoint (updates=%d)",
                     t[1])
            self.events.emit("resumed_from_preempt", updates=t[1])
            return t

        tag = None
        if pmeta is not None and (latest is None or tag_hint >= latest):
            tag = tag_candidate()
            # Compare what was actually restored (maybe the .old copy).
            if tag is not None and (latest is None or tag[1] >= latest):
                return accept(tag)
        try:
            state, step = self.checkpoints.restore(template)
        except FileNotFoundError:
            if tag is None and pmeta is not None:
                tag = tag_candidate()
            if tag is not None:
                return accept(tag)
            raise
        self._surface_restore_fallback()
        report = self.checkpoints.last_restore_report or {}
        meta = report.get("meta") or self.checkpoints.metadata(step)
        if pmeta is not None and tag is None and tag_hint > step:
            tag = tag_candidate()
        if tag is not None and tag[1] > step:
            return accept(tag)
        if tag is not None:
            log.warning("preemption checkpoint restored at updates=%d is "
                        "older than step checkpoint %d; using the step "
                        "checkpoint", tag[1], step)
        return state, step, meta

    # ---- preemption -------------------------------------------------------

    def request_preempt(self) -> None:
        """Stop at the next chunk boundary and write ``tag_preempt`` (safe
        from a signal handler: it only sets an Event). The grace deadline
        starts now."""
        if not self._preempt.is_set():
            self._preempt_deadline = (time.monotonic()
                                      + self.cfg.runtime.preempt_grace_s)
        self._preempt.set()

    def _wait_backoff(self, delay: float) -> bool:
        """Backoff sleep that wakes early on preemption; True when stop was
        requested."""
        deadline = time.monotonic() + delay
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0 or self._preempt.is_set():
                return False
            if self._stop.wait(min(remaining, 0.1)):
                return True

    def _preempt_shutdown(self) -> None:
        """At a chunk boundary, inside ``runtime.preempt_grace_s``: pending
        saves land, then the emergency ``tag_preempt`` checkpoint with the
        resume metadata. Never raises: a failure here degrades durability
        but must not turn a preemption into a restart."""
        grace = self.cfg.runtime.preempt_grace_s
        deadline = self._preempt_deadline or (time.monotonic() + grace)
        log.warning("preemption requested; writing an emergency checkpoint "
                    "(%.1fs of the %.1fs grace left)",
                    max(0.0, deadline - time.monotonic()), grace)
        saved = False
        try:
            updates = int(self._ts.updates)
            env_steps = int(self._ts.env_steps)
            self.checkpoints.wait_pending(
                timeout=max(0.5, deadline - time.monotonic()))
            self.checkpoints.save_tagged(
                "preempt", self._ts,
                metadata={"updates": updates, "env_steps": env_steps,
                          "episode": self.episode, "preempted": True})
            saved = True
            self.events.emit("preempted", updates=updates,
                             env_steps=env_steps, episode=self.episode)
            log.warning("emergency checkpoint tag_preempt written "
                        "(updates=%d, env_steps=%d, episode=%d)",
                        updates, env_steps, self.episode)
        except Exception:
            log.exception("preemption drain failed; exiting with whatever "
                          "was already durable")
        self.preempt_saved = saved
        self.preempted = True

    # ---- queries ----------------------------------------------------------

    def is_everything_done(self) -> QueryReply:
        phase = self.lifecycle.phase
        if phase is Phase.AWAITING_DATA:
            return QueryReply(ReplyState.NO_TRAINING_DATA)
        if phase in (Phase.READY, Phase.TRAINING):
            return QueryReply(ReplyState.TRAINING_NOT_COMPLETED)
        if phase is Phase.FAILED:
            return QueryReply(ReplyState.NOT_COMPUTED)
        return QueryReply(ReplyState.COMPLETED)

    def _stat(self, key: str, *, trained_only: bool = False) -> QueryReply:
        phase = self.lifecycle.phase
        if phase is Phase.AWAITING_DATA:
            return QueryReply(ReplyState.NO_TRAINING_DATA)
        if phase is Phase.FAILED:
            return QueryReply(ReplyState.NOT_COMPUTED)
        with self._snapshot_lock:
            snap = dict(self._snapshot)
        if trained_only:
            # The reference's GetAvg: only agents whose episode finished.
            if snap.get("trained_workers", 0.0) < 1.0:
                return QueryReply(ReplyState.NOT_COMPUTED)
            key = f"{key}_trained"
        value = snap.get(key)
        if value is None:
            return QueryReply(ReplyState.NOT_COMPUTED)
        return QueryReply(ReplyState.RESULT, value)

    def get_avg(self, *, trained_only: bool | None = None) -> QueryReply:
        if trained_only is None:
            trained_only = self.cfg.runtime.query_trained_only
        return self._stat("portfolio_mean", trained_only=trained_only)

    def get_std(self, *, trained_only: bool | None = None) -> QueryReply:
        if trained_only is None:
            trained_only = self.cfg.runtime.query_trained_only
        return self._stat("portfolio_std", trained_only=trained_only)

    def snapshot(self) -> dict[str, float]:
        with self._snapshot_lock:
            return dict(self._snapshot)

    # ---- greedy evaluation ---------------------------------------------------

    def evaluate(self) -> dict[str, float]:
        """Greedy-policy evaluation of the current params: one argmax replay
        of the episode, no exploration, no update; the training state is
        untouched. Under ``runtime.keep_best_eval`` a policy better than the
        best seen (across resumes: ``tag_best``'s metadata seeds the bar) is
        saved as ``tag_best``."""
        if self.agent is None or self._ts is None:
            raise RuntimeError("no training data / state")
        ts = self._snapshot_ts()
        result = self._evaluate_params(ts.params)
        updates = int(ts.updates)
        self.events.emit("evaluation", updates=updates, **result)
        if self.cfg.runtime.keep_best_eval:
            # Locked check-then-act: a periodic and an explicit eval may
            # race, and a worse policy must not overwrite a better tag.
            with self._best_eval_lock:
                if self._best_eval is None:
                    prior = self.checkpoints.tagged_metadata("best")
                    self._best_eval = (float(prior["eval_portfolio"])
                                       if prior else float("-inf"))
                if result["eval_portfolio"] > self._best_eval:
                    self._best_eval = result["eval_portfolio"]
                    self.checkpoints.save_tagged(
                        "best", ts,
                        metadata={"eval_portfolio": result["eval_portfolio"],
                                  "updates": updates})
                    self.events.emit(
                        "best_eval_retained",
                        eval_portfolio=result["eval_portfolio"],
                        updates=updates)
        return result

    def evaluate_best(self) -> dict[str, float]:
        """Greedy evaluation of the retained best policy (``tag_best``);
        raises ``FileNotFoundError`` when nothing was retained."""
        if self.agent is None or self._ts is None:
            raise RuntimeError("no training data / state")
        template = self.agent.init(self.cfg.seed)
        state, meta = self.checkpoints.restore_tagged(template, "best")
        result = self._evaluate_params(state.params)
        result["eval_updates"] = float(meta.get("updates", -1))
        return result

    def _evaluate_params(self, params) -> dict[str, float]:
        """The greedy replay in the precision the policy trains in (the
        compute copy of the fp32 masters)."""
        model, env = self.agent.model, self.env
        compute = self._precision.cast_compute(params)
        if supports_precomputed_trunk(model, env):
            final, rewards = greedy_rollout_precomputed(model, env, compute)
        else:
            final, rewards = greedy_rollout(
                model, env, compute,
                self._precision.cast_carry(model.init_carry(), model))
        return {
            "eval_portfolio": float(env.portfolio_value(final)[0]),
            "eval_reward_sum": float(rewards.sum()),
        }

    # ------------------------------------------------------------------------

    def _snapshot_ts(self) -> TrainState:
        """The live state at a chunk boundary: the state itself when no
        other thread steps it, else a copy taken under the step lock."""
        if (self._thread is None or not self._thread.is_alive()
                or threading.current_thread() is self._thread):
            return self._ts
        with self._step_lock:
            return _clone_state(self._ts)

    @property
    def train_state(self) -> TrainState | None:
        return None if self._ts is None else self._snapshot_ts()

    def wait(self, timeout: float | None = None) -> bool:
        """Join the training thread; True once it has ended."""
        if self._thread is None:
            return True
        self._thread.join(timeout)
        return not self._thread.is_alive()

    def stop(self) -> None:
        """Stop the loop, then let queued async saves land (the writer is a
        daemon thread: process exit would drop them)."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=60)
        self.checkpoints.wait_pending(timeout=60)
