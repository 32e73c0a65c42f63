"""The training orchestrator: the lifecycle protocol around a chunk loop.

Counterpart of the JAX package's ``runtime/orchestrator.py``, reduced to its
chunk loop:

- the lifecycle FSM (awaiting-data -> ready -> training -> trained/
  completed), with StartTraining stashed until data arrives;
- the loop: each chunk is one ``agent.step`` (``runtime.chunk_steps`` env
  steps for the whole agent batch, then the PPO update), its metrics read
  back ONCE as one stacked tensor, the snapshot that
  ``get_avg``/``get_std``/``snapshot`` answer from replaced;
- the episode gate: an episode completes when the cumulative env-step count
  reaches ``(episode + 1) x horizon`` and every agent's cursor has reached
  the horizon; the run re-arms (fresh env state and carry, learned params
  kept) until ``runtime.episodes`` are done;
- preemption: :meth:`request_preempt` stops the loop at the next chunk
  boundary (``cli train`` maps it to exit code 75).

Not yet ported: supervision and backoff restarts, per-agent heals,
checkpoints, the async readback pipeline, megachunks, sampled metric
readback, periodic eval, roofline/obs, journaling, actor feeds and warm
starts. A non-default value of such a knob raises ``ConfigError``; where the
default itself turns the feature on, the run goes on and logs one warning
line naming what it does instead (:func:`check_ported`). A chunk whose loss
is not finite, or (with ``runtime.partial_recovery``) that reports an
unhealthy agent, fails the run: without heals or restarts there is nothing
else to do.
"""

from __future__ import annotations

import threading
import time
from typing import Any

import numpy as np
import torch

from sharetrade_tpu_torch.agents import build_agent
from sharetrade_tpu_torch.agents.base import Agent, TrainState, build_optimizer
from sharetrade_tpu_torch.config import ConfigError, FrameworkConfig
from sharetrade_tpu_torch.device import resolve_device
from sharetrade_tpu_torch.env.trading import make_trading_env
from sharetrade_tpu_torch.precision import policy_from_config
from sharetrade_tpu_torch.runtime.lifecycle import (
    Lifecycle, Phase, QueryReply, ReplyState)
from sharetrade_tpu_torch.utils.logging import get_logger

log = get_logger("runtime.orchestrator")

#: Knobs whose feature is not ported, with the default the port runs at:
#: any other value is refused.
_REFUSED = {
    "runtime.megachunk_factor": 1,
    "runtime.double_buffer_dispatch": False,
    "runtime.pipeline_depth": 2,
    "runtime.eval_every_updates": 0,
    "runtime.profile_dir": None,
    "runtime.checkpoint_dir": "checkpoints",
    "runtime.keep_checkpoints": 3,
    "runtime.backoff_initial_s": 3.0,
    "runtime.backoff_max_s": 60.0,
    "runtime.backoff_jitter": 0.2,
    "runtime.max_agent_heals": 10,
    "obs.enabled": False,
    "distrib.num_actors": 0,
    "tuning.profile": None,
}

#: Knobs whose DEFAULT turns on a feature that is not ported: the run goes
#: on, does what the message says, and says so once.
_WARNED = {
    "runtime.checkpoint_every_updates":
        (lambda v: v > 0, "checkpoints (no checkpoint is written)"),
    "runtime.async_pipeline":
        (lambda v: bool(v), "the async readback pipeline (metrics are read "
                            "back synchronously, once per chunk)"),
    "runtime.metrics_every_chunks":
        (lambda v: v != 1, "sampled metric readback (every chunk is read "
                           "back)"),
    "runtime.max_restarts":
        (lambda v: v > 0, "supervised restarts (a failing chunk fails the "
                          "run)"),
    "runtime.partial_recovery":
        (lambda v: bool(v), "per-agent heals (an unhealthy agent fails the "
                            "run)"),
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


class Orchestrator:
    """Owns the env, the agent and the training state of one run; drives
    the chunk loop on a background thread (or inline)."""

    def __init__(self, cfg: FrameworkConfig, *,
                 device: torch.device | str | None = None):
        unported = check_ported(cfg)
        if unported:
            log.warning("not yet ported, running without: %s",
                        "; ".join(unported))
        self.cfg = cfg
        self.device = resolve_device(device)
        self.lifecycle = Lifecycle()
        self._precision = policy_from_config(cfg.precision)
        self.agent: Agent | None = None
        self.env = None
        self._ts: TrainState | None = None
        self._snapshot: dict[str, float] = {}
        self._snapshot_lock = threading.Lock()
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        self._preempt = threading.Event()
        self.preempted = False
        self.restarts = 0          # supervision is not ported: always 0
        self.episode = 0
        self.chunks = 0
        self.last_error: BaseException | None = None

    # ---- protocol: SendTrainingData ------------------------------------

    def send_training_data(self, prices, *,
                           train_state: TrainState | None = None,
                           params: Any = None) -> None:
        """Build the env and the agent from a 1-D price series; start from
        a seeded init, from ``train_state`` (a converted JAX state or a
        ``.npz`` one, ``convert.py``), or from a seeded init with ``params``
        in place of its weights (and the optimizer state started fresh)."""
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
        self.episode = 0
        if train_state is not None:
            self._ts = self._adopt(train_state)
        else:
            self._ts = self.agent.init(self.cfg.seed)
            if params is not None:
                self._ts = self._ts.replace(
                    params=params,
                    opt_state=build_optimizer(self.cfg.learner).init(params))
        self.lifecycle.to(Phase.READY)
        if self.lifecycle.start_requested:
            self.lifecycle.start_requested = False
            self.start_training(
                background=getattr(self, "_stashed_background", True))

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
                             f"the series horizon ({self.env.num_steps})")
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
            self._thread = threading.Thread(target=self._run, name="trainer",
                                            daemon=True)
            self._thread.start()
        else:
            self._run()

    def initialise(self) -> None:
        """Re-arm for a fresh episode keeping learned parameters."""
        if self.agent is None or self._ts is None:
            return
        self._reset_episode()
        self.lifecycle.to(Phase.READY)

    def _reset_episode(self) -> None:
        """Fresh env cursors, carry and generator for the next episode;
        params, optimizer state, updates and the cumulative env-step count
        carry over."""
        fresh = self.agent.init(self.cfg.seed + self.episode)
        self._ts = fresh.replace(
            params=self._ts.params, opt_state=self._ts.opt_state,
            updates=self._ts.updates, env_steps=self._ts.env_steps)

    # ---- the chunk loop --------------------------------------------------

    def _read_metrics(self, metrics: dict[str, torch.Tensor]
                      ) -> dict[str, float]:
        """One device-to-host read for the whole chunk's metrics."""
        keys = list(metrics)
        stacked = torch.stack([metrics[k].detach().to(torch.float64)
                               .reshape(()) for k in keys]).cpu()
        return dict(zip(keys, stacked.tolist()))

    def _run(self) -> None:
        rt = self.cfg.runtime
        workers = self.cfg.parallel.num_workers
        horizon = self.env.num_steps
        try:
            while not self._stop.is_set():
                if self._preempt.is_set():
                    self.preempted = True
                    log.warning("preempted at a chunk boundary (chunk %d)",
                                self.chunks)
                    return
                t0 = time.perf_counter()
                self._ts, metrics = self.agent.step(self._ts)
                row = self._read_metrics(metrics)
                row["chunk_seconds"] = time.perf_counter() - t0
                self.chunks += 1
                with self._snapshot_lock:
                    self._snapshot = row
                if not np.isfinite(row["loss"]):
                    raise RuntimeError("non-finite training loss")
                if rt.partial_recovery and row["unhealthy_workers"] > 0:
                    raise RuntimeError(
                        f"{int(row['unhealthy_workers'])} agent(s) non-finite "
                        "and per-agent heals are not yet ported")
                done_steps = row["env_steps"] >= horizon * (self.episode + 1)
                stranded = (0.0 if rt.partial_recovery
                            else row["unhealthy_workers"])
                if done_steps and row["trained_workers"] + stranded >= workers:
                    self.episode += 1
                    if self.episode < rt.episodes:
                        log.info("episode %d completed; re-arming",
                                 self.episode)
                        self._reset_episode()
                        continue
                    self.lifecycle.to(Phase.TRAINED)
                    self.lifecycle.to(Phase.COMPLETED)
                    log.info("training completed at %d env steps",
                             int(row["env_steps"]))
                    return
                if (not rt.partial_recovery
                        and row["unhealthy_workers"] >= workers):
                    raise RuntimeError("all agent rows non-finite; no "
                                       "further progress is possible")
        except Exception as exc:
            self.last_error = exc
            self.lifecycle.force(Phase.FAILED)
            log.exception("training failed: %r", exc)

    def request_preempt(self) -> None:
        """Stop at the next chunk boundary (safe from a signal handler: it
        only sets an Event)."""
        self._preempt.set()

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

    @property
    def train_state(self) -> TrainState | None:
        return self._ts

    def wait(self, timeout: float | None = None) -> bool:
        """Join the training thread; True once it has ended."""
        if self._thread is None:
            return True
        self._thread.join(timeout)
        return not self._thread.is_alive()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=60)
