"""The training orchestrator: the lifecycle protocol around a supervised
chunk loop.

Counterpart of the JAX package's ``runtime/orchestrator.py``:

- the lifecycle FSM (awaiting-data -> ready -> training -> trained/
  completed), with StartTraining stashed until data arrives;
- the hot loop: each dispatch runs ``k`` chunks of the agent's step through
  its chunk program (``agents/base.py`` ``ChunkProgram``: on the card one
  CUDA graph replay a chunk, after an eager first chunk; on the CPU the
  eager step). ``runtime.megachunk_factor`` K > 1 dispatches K chunks with
  no readback between them, and falls back to K = 1 wherever even an upper
  bound on the env-step count after K more chunks reaches the episode
  threshold, so the completion gate stays exact;
- sampled readback (``runtime.metrics_every_chunks``, every chunk under a
  ``fault_hook``): between samples chunks dispatch back to back; at a
  sample the dispatch's stacked per-chunk rows are copied to the host
  (a pinned buffer and an event on the card, enqueued before the next
  dispatch overwrites them);
- the async readback pipeline (``runtime.async_pipeline``,
  ``runtime/pipeline.py``): each sample's readback goes to ONE consumer
  thread through a bounded queue (``runtime.pipeline_depth``); the
  consumer runs the rows, the fault hook and the snapshot in chunk order
  while the dispatcher keeps dispatching, and flags the rows that need a
  dispatcher action (heal, NaN supervision, eval/checkpoint cadence,
  completion); the dispatcher drains before acting on every flagged row
  in chunk order, before the K = 1 exact path, and after every boundary
  that may complete the episode or carries a ``fault_hook``. A consumer
  fault is re-raised on the dispatcher and attributed to the chunk the
  consumer stopped at. With the pipeline off, ``runtime.double_buffer_dispatch``
  (K > 1) dispatches the next megachunk before reading this one back;
- the episode gate: an episode completes when the cumulative env-step count
  reaches ``(episode + 1) x horizon`` and every agent's cursor has reached
  the horizon; the run re-arms (fresh env state and carry, learned params
  kept) until ``runtime.episodes`` are done, and writes a final checkpoint;
- supervision: a failing chunk goes through ``error_policy`` (exception
  type -> RESUME / RESTART / STOP / ESCALATE). RESTART waits an exponential
  backoff (``backoff_initial_s`` doubling up to ``backoff_max_s``, with
  ``backoff_jitter``), then restores the latest intact checkpoint or, with
  none, re-initialises; past ``max_restarts`` the run ends FAILED. The
  pipeline is quiesced and replaced on every recovery;
- per-agent heals (``partial_recovery``): a non-finite agent row is
  respawned in place, at the survivors' cursor with the representative
  row's carry, up to ``max_agent_heals`` times; shared state that is not
  finite, every row bad, or no row bad falls back to the restart path; a
  row computed before the last heal (a megachunk in flight) does not heal
  again;
- checkpoints (``checkpoint/manager.py``): a baseline before the first chunk
  and one every ``checkpoint_every_updates`` updates, both ``save_async``;
- preemption: :meth:`request_preempt` stops the loop at the next dispatch
  boundary, drains the pipeline and writes the ``tag_preempt`` checkpoint
  inside ``runtime.preempt_grace_s`` (``cli train`` maps it to exit code
  75), and ``send_training_data(..., resume=True)`` continues from it or
  from the newest intact step checkpoint;
- greedy evaluation (:meth:`evaluate`, :meth:`evaluate_best`, every
  ``eval_every_updates``): one argmax replay of the episode in the compute
  precision (through the precomputed trunk where the model has one, else
  step by step); under ``keep_best_eval`` the best policy so far is
  ``tag_best``;
- DQN's journal-backed replay (``learner.journal_replay``): every chunk's
  transitions (read back with its metrics, so a journaled run reads back
  every chunk and never double-buffers) are appended to
  ``<data.journal_dir>/transitions.journal`` as packed records stamped
  with the chunk's env-step count (``data/transitions.py``), on the
  consumer thread; a fresh run truncates the journal; a restore, a
  re-initialisation and ``--resume`` warm-start the replay buffer from its
  tail (PER priorities reseeded at the stored maximum), and its high-water
  stamp keeps a replayed chunk from being journaled twice; the journal is
  compacted (or, segmented by ``data.journal_segment_records``, its old
  segments retired) at ``2 x replay_capacity`` rows, and flushed at the
  preemption drain and at completion. The JAX package appends through its
  C++ async writer when that library is built; the port appends through
  the pure-Python journal whatever ``data.async_transition_writer`` and
  ``data.use_native_journal`` say (the same file format).

The live state (``_ts``) is a property: every assignment loads the new
state into the chunk program's buffers, which the captured graph reads.

Test seams as in the JAX package: ``step_override`` replaces the agent's
step (K = 1 and the pipeline off), ``fault_hook(chunk_idx, row)`` runs on
every chunk's metrics row.

A tuned profile (``tuning.profile``, ``tuning.py``) is applied at
construction: registered knobs still at their defaults take its values,
explicit ones win (idempotent, so a config ``cli train`` resolved already
passes through unchanged); a missing, torn or foreign profile raises
``ProfileError``, a ``ConfigError``.

Not yet ported: roofline/obs, the tracer (``runtime.profile_dir``) and
actor feeds; a non-default value of such a knob raises ``ConfigError``
(:func:`check_ported`).
"""

from __future__ import annotations

import os
import random
import threading
import time
from typing import Any, Callable

import numpy as np
import torch

from sharetrade_tpu_torch.agents import build_agent
from sharetrade_tpu_torch.agents.base import (
    Agent, ChunkProgram, MetricsReadback, StackedMetrics, TrainState,
    agent_health, build_optimizer, election_health, state_items,
    with_tensors)
from sharetrade_tpu_torch.agents.rollout import (
    greedy_rollout, greedy_rollout_precomputed, supports_precomputed_trunk)
from sharetrade_tpu_torch.agents.dqn import (
    ReplayBuffer, fill_replay_from_arrays, fill_replay_from_events,
    reseed_per_priorities)
from sharetrade_tpu_torch.checkpoint import CheckpointManager
from sharetrade_tpu_torch.config import ConfigError, FrameworkConfig
from sharetrade_tpu_torch.data.journal import segment_paths
from sharetrade_tpu_torch.data.service import _open_journal
from sharetrade_tpu_torch.data.transitions import (
    append_transitions, compact_transitions, read_tail_transitions,
    retire_transition_segments)
from sharetrade_tpu_torch.device import resolve_device
from sharetrade_tpu_torch.env.portfolio import make_portfolio_env
from sharetrade_tpu_torch.env.trading import make_trading_env
from sharetrade_tpu_torch.models.core import tree_leaves, tree_map
from sharetrade_tpu_torch.precision import policy_from_config
from sharetrade_tpu_torch.runtime.lifecycle import (
    Lifecycle, Phase, QueryReply, ReplyState)
from sharetrade_tpu_torch.runtime.pipeline import AsyncPipeline, Boundary
from sharetrade_tpu_torch.tuning import apply_profile
from sharetrade_tpu_torch.utils.logging import EventLog, get_logger
from sharetrade_tpu_torch.utils.metrics import MetricsRegistry
from sharetrade_tpu_torch.utils.profiling import StepTimer

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
    "runtime.profile_dir": None,
    "obs.enabled": False,
    "distrib.num_actors": 0,
}
#: The knobs of ``_REFUSED`` each command refuses. ``cli serve`` lets
#: ``runtime.profile_dir`` and ``distrib.num_actors`` through, as the JAX
#: package's ``cli serve`` ignores them.
TRAIN_REFUSED = ("runtime.profile_dir", "obs.enabled", "distrib.num_actors")
SERVE_REFUSED = ("obs.enabled",)


def _knob(cfg: FrameworkConfig, path: str) -> Any:
    section, key = path.split(".")
    return getattr(getattr(cfg, section), key)


def check_ported(cfg: FrameworkConfig,
                 knobs: tuple[str, ...] = TRAIN_REFUSED, *,
                 mesh: bool = True) -> None:
    """Raise ``ConfigError`` for a non-default value of an unported knob
    among ``knobs`` (and, with ``mesh``, for a multi-device mesh)."""
    for path in knobs:
        value = _knob(cfg, path)
        if value != _REFUSED[path]:
            raise ConfigError(f"{path}={value!r} is not yet ported to "
                              "sharetrade_tpu_torch")
    if mesh and cfg.parallel.mesh_shape:
        raise ConfigError("parallel.mesh_shape: multi-device layouts are not "
                          "yet ported to sharetrade_tpu_torch")


def _clone(tree):
    """A copy of a tree of tensors (dicts, lists, tuples, named tuples and
    dataclasses) that owns every tensor."""
    return with_tensors(tree, {p: t.clone() for p, t in state_items(tree)})


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
        # The tuned profile (idempotent; explicit config wins; a foreign
        # profile is a ProfileError, which supervision maps to STOP).
        cfg = apply_profile(cfg)
        check_ported(cfg)
        rt = cfg.runtime
        # Impossible compositions never heal by restarting: refused at
        # construction, as in the JAX package.
        if rt.megachunk_factor < 1:
            raise ConfigError("runtime.megachunk_factor must be >= 1, got "
                              f"{rt.megachunk_factor}")
        if rt.pipeline_depth < 1:
            raise ConfigError("runtime.pipeline_depth must be >= 1, got "
                              f"{rt.pipeline_depth}")
        if (rt.megachunk_factor > 1
                and rt.metrics_every_chunks % rt.megachunk_factor != 0):
            log.info(
                "metrics_every_chunks=%d is not a multiple of "
                "megachunk_factor=%d; metric samples land on megachunk "
                "boundaries (rounded up)",
                rt.metrics_every_chunks, rt.megachunk_factor)
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
        self.metrics = MetricsRegistry(max_points=cfg.obs.max_metric_points)
        self.agent: Agent | None = None
        self.env = None
        # The chunk program (None under step_override); set before the
        # first state so that every state assigned goes through its load.
        self._program: ChunkProgram | None = None
        self._state: TrainState | None = None
        self._snapshot: dict[str, float] = {}
        self._snapshot_lock = threading.Lock()
        # Held across each dispatch: a reader that copies the state under
        # it enqueues its copy after the last dispatched chunk, on the same
        # stream, and so sees a chunk boundary.
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
        #: Chunks whose rows the loop has committed (retried chunks twice).
        self.chunks = 0
        self.last_error: BaseException | None = None
        # The async pipeline, live while a supervised run is in flight;
        # _committed_idx is the consumer's per-row progress cursor (the
        # synchronous loop's chunk index), read for fault attribution.
        self._pl: AsyncPipeline | None = None
        self._committed_idx = 0
        self._timer: StepTimer | None = None
        #: The last run's pipeline: boundaries consumed and the largest
        #: queue depth seen (kept after shutdown).
        self.pipeline_stats: dict[str, int] = {}
        # DQN's transitions journal (learner.journal_replay), the env-step
        # stamp journaled last, and rows appended since the last compaction.
        self._transitions_journal = None
        self._journal_high_water = 0
        self._journal_rows_since_compact = 0
        if cfg.learner.algo == "dqn" and cfg.learner.journal_replay:
            self._transitions_journal = self._open_transitions_journal()

    def _open_transitions_journal(self):
        """``<data.journal_dir>/transitions.journal``, segmented when
        ``data.journal_segment_records`` > 0, with the group-commit
        watermarks (``data.journal_fsync_*``)."""
        data = self.cfg.data
        return _open_journal(
            os.path.join(data.journal_dir, "transitions.journal"),
            fsync_every_records=data.journal_fsync_every_records,
            fsync_interval_s=data.journal_fsync_interval_s,
            segment_records=data.journal_segment_records)

    # ---- the live state ---------------------------------------------------

    @property
    def _ts(self) -> TrainState | None:
        return self._state

    @_ts.setter
    def _ts(self, ts: TrainState | None) -> None:
        # A heal, re-arm, restore or resume hands in fresh tensors: the
        # captured graph reads its own buffers, so the values go there.
        if self._program is not None and ts is not None:
            ts = self._program.load(ts)
        self._state = ts

    # ---- protocol: SendTrainingData ------------------------------------

    def send_training_data(self, prices, *, resume: bool = False,
                           train_state: TrainState | None = None,
                           params: Any = None) -> None:
        """Build the env and the agent from a price series: 1-D for the
        single-asset env, (A, T) for the multi-asset portfolio. The state
        is the latest checkpoint with ``resume`` (``tag_preempt`` when it is
        at least as new as the newest intact step; ``FileNotFoundError``
        when there is none), ``train_state`` (a converted JAX state or a
        ``.npz`` one, ``convert.py``), a seeded init with ``params`` in
        place of its weights (the optimizer state started fresh; DQN's
        target network a copy of them), or a seeded init. Every state but
        ``resume``'s starts a fresh transitions journal."""
        prices = np.asarray(prices)
        env_cfg = self.cfg.env
        if prices.ndim == 2 and prices.shape[0] > 1:
            self.env = make_portfolio_env(
                prices, window=env_cfg.window,
                initial_budget=env_cfg.initial_budget,
                initial_shares=env_cfg.initial_shares, device=self.device)
        else:
            self.env = make_trading_env(
                prices.reshape(-1), window=env_cfg.window,
                initial_budget=env_cfg.initial_budget,
                initial_shares=env_cfg.initial_shares, device=self.device)
        self.agent = build_agent(self.cfg, self.env, device=self.device)
        self._program = (None if self._step_override is not None
                         else ChunkProgram(self.agent))
        template = self.agent.init(self.cfg.seed)
        self.episode = 0
        if not resume and self._transitions_journal is not None:
            # A fresh run does not inherit another run's experience: the
            # journal is truncated and its high-water stamp reset.
            self._transitions_journal.compact([])
            self._journal_high_water = 0
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
        self._ts = self._adopt(self._warm_start_replay(state))
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
        """One device-to-host read for a ``step_override`` chunk's tensor
        metrics (it may return plain numbers)."""
        keys = [k for k, v in metrics.items() if isinstance(v, torch.Tensor)]
        row = {k: float(v) for k, v in metrics.items() if k not in keys}
        if keys:
            stacked = torch.stack([metrics[k].detach().to(torch.float64)
                                   .reshape(()) for k in keys]).cpu()
            row.update(zip(keys, stacked.tolist()))
        return {k: row[k] for k in metrics}

    def _dispatch(self, k: int):
        """``k`` chunks from the live state, under the step lock; returns
        the chunk program's :class:`StackedMetrics` (a ``step_override``'s
        metrics dict as it is)."""
        with self._step_lock:
            if self._step_override is not None:
                self._ts, metrics = self._step_override(self._ts)
                return metrics
            self._ts, stacked = self._program(self._ts, k)
            return stacked

    def _start_readback(self, metrics) -> MetricsReadback:
        """Enqueue a dispatch's rows to the host, before the next dispatch
        overwrites the program's buffer."""
        if isinstance(metrics, StackedMetrics):
            return self._program.readback(metrics)
        metrics = dict(metrics)
        transitions = metrics.pop("transitions", None)
        row = self._read_metrics(metrics)
        return MetricsReadback(tuple(row), torch.tensor(
            [list(row.values())], dtype=torch.float64),
            transitions=None if transitions is None else
            {k: v.detach().cpu()[None] for k, v in transitions.items()})

    def _new_pipeline(self) -> AsyncPipeline:
        return AsyncPipeline(self.cfg.runtime.pipeline_depth,
                             self._host_process,
                             attn_check=self._row_needs_attention)

    def _run_supervised(self) -> None:
        """The dispatcher, as in the JAX package: dispatches chunks and
        makes every state-changing decision; with the pipeline on, the
        readback and the rows' host work run on the consumer thread
        (:meth:`_host_process`), with it off inline."""
        rt = self.cfg.runtime
        horizon = self.env.num_steps
        chunk_idx = 0
        self._last_ckpt_updates = 0
        # A fault hook samples every chunk, so that an injected fault
        # surfaces on the chunk that raised it.
        metrics_every = (1 if self._fault_hook is not None
                         else max(1, rt.metrics_every_chunks))
        mega = rt.megachunk_factor if self._program is not None else 1
        # A journaled run reads every chunk's transitions back.
        journaled = self._transitions_journal is not None
        timer = StepTimer(rt.chunk_steps, self.cfg.parallel.num_workers,
                          max_history=self.cfg.obs.max_timer_history or None)
        self._timer = timer
        updates0, env_steps0 = (int(v) for v in torch.stack(
            [self._ts.updates, self._ts.env_steps]).tolist())
        # Baseline before the first chunk unless an INTACT checkpoint could
        # already serve a restore: "lose at most checkpoint_every_updates
        # updates" holds from chunk 0.
        if rt.checkpoint_every_updates > 0 and not self.checkpoints.any_intact():
            self.checkpoints.save_async(
                updates0, self._ts,
                metadata={"episode": self.episode, "env_steps": env_steps0})
        timer.tick()
        last_env_steps: int | None = env_steps0
        chunks_since = 0   # chunks since the last materialization decision
        chunks_ahead = 0   # chunks dispatched past the last boundary row SEEN
        self._committed_idx = 0
        # Double-buffered dispatch (sync path, K > 1): the (readback, K,
        # heals at dispatch) of a megachunk already dispatched while its
        # predecessor's rows are read back. The heals mark lets the health
        # check recognise a stale report from before a boundary heal.
        pending: tuple[MetricsReadback, int, int] | None = None
        # The pipeline: off under the step_override seam (lockstep).
        pl: AsyncPipeline | None = None
        if rt.async_pipeline and self._step_override is None:
            self.pipeline_stats = {}
            pl = self._new_pipeline()
        self._pl = pl
        # The chunk position of the boundary row being acted on in the
        # attention path: a raise from there belongs to ITS chunk.
        acting_chunk: int | None = None
        try:
            while not self._stop.is_set():
                in_step = False
                try:
                    acting_chunk = None
                    if self._preempt.is_set():
                        self._preempt_shutdown(pl)
                        return
                    if pl is not None and (pl.error is not None
                                           or pl.attention.is_set()):
                        # A consumer fault, or rows that need an action:
                        # drain so every queued readback lands in order.
                        pl.drain()
                        pl.attention.clear()
                        if pl.error is not None:
                            chunk_idx = self._committed_idx
                            raise pl.error
                        if pl.last_row is not None:
                            last_env_steps = int(pl.last_row["env_steps"])
                            chunks_ahead = chunk_idx - self._committed_idx
                        # Act on EVERY flagged row, in chunk order.
                        for row, mark, end_idx in pl.take_attention():
                            acting_chunk = end_idx
                            ret = self._boundary_actions(row, mark, horizon)
                            if ret == "completed":
                                return
                            if ret == "rearmed":
                                break   # later rows predate the re-arm
                        continue
                    if last_env_steps is None:   # after any recovery
                        last_env_steps = int(self._ts.env_steps)
                        chunks_since = 0
                        chunks_ahead = 0
                    threshold = horizon * (self.episode + 1)
                    readback = None
                    if pending is not None:
                        readback, k, heals_mark = pending
                        pending = None
                    else:
                        heals_mark = self.agent_heals
                        # Fuse K chunks only while even the env-step UPPER
                        # BOUND after K more chunks stays below the
                        # threshold: no inner chunk can complete the episode.
                        can_fuse = (mega > 1
                                    and (last_env_steps + (chunks_ahead + mega)
                                         * rt.chunk_steps) < threshold)
                        if (pl is not None and mega > 1 and not can_fuse
                                and chunks_ahead > 0):
                            # Drain before the K=1 exact path: the bound
                            # staled while boundaries were in flight. Only a
                            # refresh that MOVED it re-enters the loop.
                            if (pl.drain() and pl.error is None
                                    and pl.last_row is not None):
                                refreshed = (int(pl.last_row["env_steps"]),
                                             chunk_idx - self._committed_idx)
                                if refreshed != (last_env_steps, chunks_ahead):
                                    last_env_steps, chunks_ahead = refreshed
                                    continue
                        k = mega if can_fuse else 1
                        in_step = True
                        metrics = self._dispatch(k)
                        in_step = False
                    chunks_since += k
                    chunks_ahead += k
                    est_env_steps = min(
                        last_env_steps + chunks_ahead * rt.chunk_steps,
                        threshold)
                    if (chunks_since < metrics_every and not journaled
                            and est_env_steps < threshold):
                        chunk_idx += k
                        continue        # no readback between samples
                    if readback is None:
                        readback = self._start_readback(metrics)
                    if pl is not None:
                        boundary = Boundary(chunk_idx, k, readback, None,
                                            heals_mark, chunks_since)
                        if not pl.try_put(boundary):
                            ok = pl.put(boundary, stop=self._stop)
                            self.metrics.inc("pipeline_stalls_total")
                            if not ok:
                                continue   # fault/stop: the loop top acts
                        self.metrics.record("pipeline_queue_depth",
                                            pl.qsize())
                        chunk_idx += k
                        chunks_since = 0
                        if (est_env_steps >= threshold
                                or self._fault_hook is not None):
                            # This boundary MAY complete the episode (or a
                            # hook may change the state): wait for its row.
                            if (pl.drain() and pl.error is None
                                    and pl.last_row is not None):
                                last_env_steps = int(pl.last_row["env_steps"])
                                chunks_ahead = chunk_idx - self._committed_idx
                        continue
                    if (rt.double_buffer_dispatch and k > 1
                            and not journaled and self._fault_hook is None
                            and (last_env_steps + (chunks_ahead + k)
                                 * rt.chunk_steps) < threshold):
                        # Dispatch the next megachunk before reading this
                        # one's rows (their copy is already enqueued):
                        # decisions below act on a state one megachunk
                        # ahead of the rows, as in the JAX package.
                        in_step = True
                        ahead = self._dispatch(k)
                        in_step = False
                        pending = (self._start_readback(ahead), k,
                                   self.agent_heals)
                    row = self._host_process(Boundary(
                        chunk_idx, k, readback, None, heals_mark,
                        chunks_since))
                    chunk_idx = self._committed_idx
                    last_env_steps = int(row["env_steps"])
                    chunks_since = 0
                    chunks_ahead = 0
                    if self._boundary_actions(row, heals_mark,
                                              horizon) == "completed":
                        return
                except Exception as exc:  # the supervision decider
                    last_env_steps = None   # resync after any recovery
                    pending = None          # the megachunk in flight is stale
                    pipeline_fault = pl is not None and exc is pl.error
                    if pl is not None:
                        # Queued boundaries were computed from state the
                        # recovery rewinds: stale; the next segment
                        # re-materializes those chunks.
                        pl.shutdown()
                        self._record_pipeline_stats(pl)
                        pl = self._new_pipeline()
                        self._pl = pl
                    # A consumer fault belongs to the chunk the consumer
                    # committed last; a raise from the attention path to the
                    # row it acted on; any other to its own position.
                    if pipeline_fault:
                        chunk_idx = self._committed_idx
                    elif acting_chunk is not None:
                        chunk_idx = acting_chunk
                    else:
                        chunk_idx = max(chunk_idx, self._committed_idx)
                    self.last_error = exc
                    verb = self._decide(exc)
                    self.events.emit("worker_failed", error=repr(exc),
                                     verb=verb, restarts=self.restarts + 1)
                    if verb == RESUME:
                        log.warning("resuming after %r (policy: resume)", exc)
                        if in_step:
                            # The step updates the state in place: a fault
                            # inside it leaves no state to resume from.
                            log.warning("the failed step may have updated "
                                        "the state in place; restoring")
                            self._restore_or_reinit()
                        timer.rebase()
                        continue
                    if verb == STOP:
                        self.lifecycle.force(Phase.FAILED)
                        log.error("stopping after %r (policy: stop)", exc)
                        return
                    if verb == ESCALATE:
                        self.lifecycle.force(Phase.FAILED)
                        raise
                    self.restarts += 1
                    self.metrics.inc("restarts_total")
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
                    timer.rebase()
        finally:
            self._pl = None
            if pl is not None:
                pl.shutdown()
                self._record_pipeline_stats(pl)

    def _record_pipeline_stats(self, pl: AsyncPipeline) -> None:
        self.pipeline_stats = {
            "max_depth_seen": max(
                self.pipeline_stats.get("max_depth_seen", 0),
                pl.max_depth_seen),
            "boundaries": (self.pipeline_stats.get("boundaries", 0)
                           + pl.processed),
        }

    def _host_process(self, b: Boundary) -> dict[str, float]:
        """The consumer half: the boundary's rows from the host copy (the
        wait is on its event alone), then per row the fault hook and the
        metric stream, strictly in chunk order; the boundary row, with the
        timer's rates, becomes the snapshot. On the consumer thread with
        the pipeline on, inline otherwise. ``_committed_idx`` advances per
        row: the fault-attribution cursor."""
        self._committed_idx = b.base
        rows = b.metrics.rows()
        transitions = b.metrics.transitions()
        for i, row in enumerate(rows):
            if transitions is not None:
                # Per inner chunk, stamped with that chunk's env steps.
                self._journal_transitions(
                    {k: v[i] for k, v in transitions.items()},
                    int(row["env_steps"]))
            if self._fault_hook is not None:
                # Per inner chunk with its TRUE index: a fault mid-megachunk
                # surfaces at the boundary, attributed to its chunk.
                self._fault_hook(b.base + i, row)
            self._committed_idx = b.base + i + 1
            if i + 1 < b.k:
                self.metrics.record_many(row)
        metrics = rows[-1]
        metrics.update(self._timer.tick(b.chunks_covered))
        self.chunks += b.chunks_covered
        with self._snapshot_lock:
            self._snapshot = metrics
        self.metrics.record_many(metrics)
        return metrics

    def _row_needs_attention(self, row: dict[str, float]) -> bool:
        """Consumer-side hint: does this boundary row need a dispatcher
        action (heal, NaN supervision, eval/checkpoint cadence, episode
        completion)? Over-triggering is harmless: the dispatcher drains and
        re-checks the exact conditions in :meth:`_boundary_actions`."""
        rt = self.cfg.runtime
        unhealthy = row.get("unhealthy_workers", 0)
        if rt.partial_recovery and unhealthy > 0:
            return True
        if rt.partial_recovery and not np.isfinite(row.get("loss", 0.0)):
            return True
        if (not rt.partial_recovery
                and unhealthy >= self.cfg.parallel.num_workers):
            return True
        updates = int(row.get("updates", 0))
        last = self._last_ckpt_updates
        for every in (rt.eval_every_updates, rt.checkpoint_every_updates):
            if every > 0 and updates // every > last // every:
                return True
        return (int(row.get("env_steps", 0))
                >= self.env.num_steps * (self.episode + 1))

    def _boundary_actions(self, metrics: dict[str, float], heals_mark: int,
                          horizon: int) -> str | None:
        """Decisions on a boundary row: per-agent heals, NaN supervision
        (raises feed the decider), eval and checkpoint cadence, and the
        episode gate. Under the pipeline it runs only after a drain, so the
        live state is at or past the row. Returns "completed", "rearmed" or
        None."""
        rt = self.cfg.runtime
        workers = self.cfg.parallel.num_workers
        if (rt.partial_recovery and metrics.get("unhealthy_workers", 0) > 0
                # A stale report from a megachunk dispatched before the last
                # heal: the next fresh one re-reports a persistent fault.
                and heals_mark == self.agent_heals):
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
            self.metrics.inc("checkpoints_total")
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
            self.metrics.inc("episodes_completed_total")
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
            # Completion is a durability point: every journaled chunk is on
            # disk when the lifecycle says done.
            self._flush_journal()
            self.lifecycle.to(Phase.TRAINED)
            self.lifecycle.to(Phase.COMPLETED)
            self.events.emit("training_completed",
                             env_steps=int(metrics["env_steps"]),
                             episodes=self.episode, **self._timer.summary())
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
            fresh_carry = tree_map(lambda c: c[rep:rep + 1].expand(c.shape),
                                   ts.carry)
        self._ts = ts.replace(
            env_state=type(ts.env_state)(*[
                splice(c, n) for c, n in zip(ts.env_state.leaves(),
                                             fresh_env.leaves())]),
            carry=tree_map(splice, ts.carry, fresh_carry))
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
            self._ts = self._warm_start_replay(state)
            self.events.emit("restored", step=step)
        except FileNotFoundError:
            self._ts = self._warm_start_replay(template)
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

    def _preempt_shutdown(self, pl: AsyncPipeline | None) -> None:
        """At a dispatch boundary, inside ``runtime.preempt_grace_s``:
        queued readbacks drain in order, pending saves land, then the
        emergency ``tag_preempt`` checkpoint with the resume metadata.
        Never raises: a failure here degrades durability but must not turn
        a preemption into a restart."""
        grace = self.cfg.runtime.preempt_grace_s
        deadline = self._preempt_deadline or (time.monotonic() + grace)
        log.warning("preemption requested; draining for an emergency "
                    "checkpoint (%.1fs of the %.1fs grace left)",
                    max(0.0, deadline - time.monotonic()), grace)
        saved = False
        try:
            if pl is not None:
                pl.drain(timeout_s=max(0.5, deadline - time.monotonic()))
            updates, env_steps = (int(v) for v in torch.stack(
                [self._ts.updates, self._ts.env_steps]).tolist())
            self.checkpoints.wait_pending(
                timeout=max(0.5, deadline - time.monotonic()))
            self.checkpoints.save_tagged(
                "preempt", self._ts,
                metadata={"updates": updates, "env_steps": env_steps,
                          "episode": self.episode, "preempted": True})
            saved = True
            self._flush_journal()
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

    # ---- journal-backed replay (learner.journal_replay) -------------------

    def _flush_journal(self) -> None:
        if self._transitions_journal is not None:
            self._transitions_journal.flush()

    def _journal_transitions(self, transitions: dict, env_steps: int) -> None:
        """Append one chunk's transitions, ``(T, B, ...)`` numpy arrays, as
        one packed record stamped ``env_steps``: rows flattened (T, B)
        row-major under the ``valid`` mask (the order the replay pushes
        them in). A chunk at or below the high-water stamp (replayed after a
        restore) is not journaled again. Every ``replay_capacity`` new rows
        the journal keeps only its newest ``2 x replay_capacity`` rows."""
        if self._transitions_journal is None:
            return
        if env_steps <= self._journal_high_water:
            return
        self._journal_high_water = env_steps
        valid = np.asarray(transitions["valid"]).reshape(-1)
        if not valid.any():
            return
        flat = {k: np.asarray(v).reshape((-1,) + np.asarray(v).shape[2:])
                for k, v in transitions.items() if k != "valid"}
        append_transitions(
            self._transitions_journal, flat["obs"][valid],
            flat["action"][valid], flat["reward"][valid],
            flat["next_obs"][valid], env_steps=env_steps)
        capacity = self.cfg.learner.replay_capacity
        self._journal_rows_since_compact += int(valid.sum())
        segmented = self.cfg.data.journal_segment_records > 0
        if self._journal_rows_since_compact >= capacity:
            if segmented:
                retired, freed = retire_transition_segments(
                    self._transitions_journal, 2 * capacity)
                if freed:
                    self.metrics.inc("journal_compacted_bytes_total", freed)
                if retired:
                    self.metrics.inc("journal_segments_retired_total",
                                     retired)
            else:
                compact_transitions(self._transitions_journal, 2 * capacity)
            self._journal_rows_since_compact = 0
        if segmented:
            self.metrics.record(
                "journal_segments",
                len(segment_paths(self._transitions_journal.path)) + 1)

    def _warm_start_replay(self, state: TrainState) -> TrainState:
        """``state`` with DQN's replay rebuilt from the transitions
        journal's tail: the rows stamped at or below ``state.env_steps``
        (the chunks after it re-run and push their own), the newest that
        fit the capacity, pushed oldest first into a fresh buffer (legacy
        JSON ``transitions`` events first); under PER the sum-tree is
        reseeded at the stored max priority. The journal's high-water stamp
        is recovered either way. ``state`` itself when nothing was
        journaled."""
        if self._transitions_journal is None:
            return state
        capacity = self.cfg.learner.replay_capacity
        cutoff = int(state.env_steps)
        events = [e for e in self._transitions_journal.replay()
                  if e.get("type") == "transitions"]
        tail = read_tail_transitions(self._transitions_journal.path,
                                     capacity if cutoff > 0 else 1,
                                     cutoff_env_steps=cutoff,
                                     journal=self._transitions_journal)
        self._journal_high_water = max(
            [self._journal_high_water]
            + [e.get("env_steps", 0) for e in events]
            + ([tail[4]] if tail is not None else []))
        fresh = ReplayBuffer.create(capacity, self.agent.model.obs_dim,
                                    self.device)
        warm = fill_replay_from_events(
            fresh, [e for e in events if e.get("env_steps", 0) <= cutoff])
        if tail is not None and cutoff > 0:
            warm = fill_replay_from_arrays(warm, *tail[:4])
        size = int(warm.size)
        if size == 0:
            return state            # nothing journaled yet: as restored
        log.info("warm-started replay buffer with %d journaled transitions",
                 size)
        self.events.emit("replay_warm_started", size=size)
        extras = state.extras
        return state.replace(extras=reseed_per_priorities(type(extras)(
            target_params=extras.target_params, replay=warm,
            per=extras.per)))

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
        if self._transitions_journal is not None:
            self._transitions_journal.close()
            self._transitions_journal = None
