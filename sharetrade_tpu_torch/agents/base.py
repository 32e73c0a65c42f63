"""Learner interface, shared RL machinery and the chunk program.

Counterpart of the JAX package's ``agents/base.py``. Every learner exposes
``init(seed) -> TrainState``, ``step(TrainState, draws=None) -> (TrainState,
metrics)``, where one step advances ``steps_per_chunk`` env steps for the
whole agent batch and runs the learning update, and ``draw(TrainState)``,
which takes one chunk's randomness from ``ts.rng`` in the order the step
would take it (``step(ts)`` is ``step(ts, draws=draw(ts))``).

The JAX package compiles the step into one program and fuses K of them
into a scan (``megachunk_step``). Here :class:`ChunkProgram` is that
program: on the CPU it calls the step eagerly; on the card it runs the
first chunk eagerly, then captures one chunk in a CUDA graph and replays it
once per chunk (K replays for a K-chunk dispatch). Per-chunk metrics come
back stacked on a leading ``(K,)`` axis either way, and so do a DQN chunk's
transitions when the agent collects them (``learner.journal_replay``).
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import gc
import time
from dataclasses import dataclass, replace
from typing import Any, Callable, NamedTuple

import torch

from sharetrade_tpu_torch.config import LearnerConfig
from sharetrade_tpu_torch.env.core import TradingEnv
from sharetrade_tpu_torch.models.core import rows_finite, tree_map
from sharetrade_tpu_torch.ops.fused_update import (
    OPTIMIZERS, fused_apply, init_state)
from sharetrade_tpu_torch.precision import FP32, PrecisionPolicy


@dataclass
class TrainState:
    """Everything a learner threads between chunks: parameters, optimizer
    state, the batched model carry and env state, the random generator, the
    counters (``env_steps``, ``updates``: int32 device scalars) and the
    learner's own state (``extras``: DQN's target network, replay and
    sum-tree, ``agents/dqn.py``; None for every other learner)."""

    params: Any
    opt_state: Any
    carry: Any               # (B, ...) model recurrent state
    env_state: Any           # batched EnvState
    rng: torch.Generator
    env_steps: torch.Tensor
    updates: torch.Tensor
    extras: Any = None

    def replace(self, **changes) -> "TrainState":
        return replace(self, **changes)


@dataclass(frozen=True)
class Agent:
    """A learner: ``init``/``step`` plus static shape facts."""

    name: str
    init: Callable[[int], TrainState]
    step: Callable[..., tuple[TrainState, dict[str, torch.Tensor]]]
    num_agents: int
    steps_per_chunk: int
    model: Any = None
    # (compute params, traj_mb, carry_mb, adv_mb, ret_mb) -> (loss terms,
    # grads): one minibatch's loss and gradients, as ``step`` computes them
    # (``chip_smoke.py`` holds the kernels' gradients against the plain
    # attention's with it).
    minibatch_grads: Callable | None = None
    # ts -> the draws ``step(ts, draws=...)`` takes: one chunk's randomness
    # from ``ts.rng``, in the order the step draws it (the generator
    # advances exactly as a call without draws advances it).
    draw: Callable[[TrainState], Any] | None = None


class Optimizer(NamedTuple):
    """The optimizer a learner applies: its name and learning rate, and the
    optax-shaped initial state (``ops/fused_update.init_state``)."""

    name: str
    learning_rate: float

    def init(self, params: Any) -> tuple:
        return init_state(self.name, params)


def build_optimizer(cfg: LearnerConfig) -> Optimizer:
    """adagrad (optax's default ``initial_accumulator_value=0.1``, TF's
    AdaGrad), adam or sgd at ``cfg.learning_rate``."""
    if cfg.optimizer not in OPTIMIZERS:
        raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
    return Optimizer(cfg.optimizer, float(cfg.learning_rate))


def make_update_fn(optimizer: Optimizer, precision: PrecisionPolicy = FP32):
    """The optimizer-update seam every learner applies its gradients
    through: ``update(grads, opt_state, params) -> (params, opt_state,
    compute)``, where ``compute`` is the copy of the updated masters the
    next forward and backward run on.

    ``grads`` arrive in whatever dtype the loss backward produced (bf16
    under ``bf16_mixed``: differentiation runs against the compute copy);
    the fused pass upcasts them, and under ``bf16_mixed`` writes the next
    bf16 compute copy in the same pass (``emit_compute``); in fp32 the
    compute copy is the masters themselves. Every ``precision.fused_update``
    setting routes through ``ops/fused_update.fused_apply``: the JAX package
    pins the optax pair and the fused pass bit-identical in fp32
    (tests/test_precision.py), and the port has no optax. The update is IN
    PLACE: the master parameters and the moments are written where they
    were read, and the same objects are returned. ``gate``, a one-element
    device tensor, keeps everything as it was where it is false: the JAX
    learners' ``where(any_active, new, old)`` over params and optimizer
    state, without a host synchronisation."""
    name, lr = optimizer.name, optimizer.learning_rate

    if precision.mixed:
        def update(grads, opt_state, params, gate=None):
            return fused_apply(name, lr, grads, opt_state, params,
                               emit_compute=True, gate=gate)
    else:
        def update(grads, opt_state, params, gate=None):
            params, opt_state = fused_apply(name, lr, grads, opt_state, params,
                                            gate=gate)
            return params, opt_state, params

    return update


def exploit_probability(step: torch.Tensor, cfg: LearnerConfig
                        ) -> torch.Tensor:
    """P(exploit) = min(epsilon, step / ramp): fully random at step 0,
    ramping to epsilon-greedy (QDecisionPolicyActor.scala:58)."""
    return torch.clamp(step.float() / cfg.epsilon_ramp_steps,
                       max=float(cfg.epsilon))


def per_beta(step: torch.Tensor, cfg: LearnerConfig) -> torch.Tensor:
    """Prioritized replay's importance-sampling exponent: annealed from
    ``per_beta0`` to 1 over ``per_beta_steps`` env steps."""
    frac = step.float() / max(1, cfg.per_beta_steps)
    return torch.clamp(cfg.per_beta0 + (1.0 - cfg.per_beta0) * frac, max=1.0)


def epsilon_greedy(q_values: torch.Tensor, gate_u: torch.Tensor,
                   random_action: torch.Tensor, step: torch.Tensor,
                   cfg: LearnerConfig) -> torch.Tensor:
    """(B, A) Q-values -> (B,) actions (QDecisionPolicyActor.scala:58-62):
    the argmax (the first index among ties, as ``jnp.argmax``) where the
    uniform ``gate_u`` is below the exploit probability, else
    ``random_action``. The JAX package draws both per agent from its key;
    here they come in as (B,) tensors (the learner's chunk draws)."""
    exploit = gate_u < exploit_probability(step, cfg)
    return torch.where(exploit, torch.argmax(q_values, dim=-1), random_action)


def select_rows(mask: torch.Tensor, new, old):
    """``where(mask, new, old)`` over two env states (or any objects with
    ``leaves()``), the (B,) mask broadcast over each field."""
    return type(old)(*[
        torch.where(mask.reshape((-1,) + (1,) * (o.ndim - 1)), n, o)
        for n, o in zip(new.leaves(), old.leaves())])


def make_init(model, env: TradingEnv, optimizer: Optimizer,
              precision: PrecisionPolicy, num_agents: int,
              extras: Callable[[Any], Any] | None = None):
    """A learner's ``init(seed) -> TrainState``: parameters drawn on the
    CPU from ``seed`` (the same weights on every device), the optimizer's
    initial state, the reset env and carry broadcast over the agents, a
    generator on the model's device for the step's draws, and
    ``extras(params)`` when the learner keeps state of its own."""
    device = model.device

    def init(seed: int) -> TrainState:
        params = model.init(torch.Generator().manual_seed(seed))
        return TrainState(
            params=params, opt_state=optimizer.init(params),
            carry=precision.cast_carry(batched_carry(model, num_agents),
                                       model),
            env_state=batched_reset(env, num_agents),
            rng=torch.Generator(device=device).manual_seed(seed + 1),
            env_steps=torch.zeros((), dtype=torch.int32, device=device),
            updates=torch.zeros((), dtype=torch.int32, device=device),
            extras=None if extras is None else extras(params))

    return init


def batched_reset(env: TradingEnv, num_agents: int):
    """One reset state broadcast over the agent batch (views: rows share
    storage until a step writes new tensors)."""
    return env.reset().map(lambda x: x.expand((num_agents,) + x.shape))


def batched_carry(model, num_agents: int):
    """One session's initial carry broadcast over the agent batch (a dict,
    or the LSTM's ``(h, c)`` tuple)."""
    return tree_map(lambda v: v.expand((num_agents,) + v.shape),
                    model.init_carry())


def healthy_mask(obs: torch.Tensor) -> torch.Tensor:
    """(B, obs_dim) -> (B,) bool: rows that are entirely finite."""
    return torch.isfinite(obs).all(dim=-1)


def agent_health(env_state) -> torch.Tensor:
    """(B,) bool: True where every env-state field row is finite."""
    leaves = env_state.leaves()
    b = leaves[0].shape[0]
    ok = torch.ones((b,), dtype=torch.bool, device=leaves[0].device)
    for leaf in leaves:
        ok = ok & torch.isfinite(leaf).reshape(b, -1).all(dim=-1)
    return ok


def election_health(env_state, carry) -> torch.Tensor:
    """(B,) bool: the row predicate of the representative election — env
    state AND model carry rows finite (a finite wallet with a NaN K/V cache
    must never be elected: its carry would feed every agent's trunk)."""
    ok = agent_health(env_state)
    return ok & rows_finite(carry, ok.shape[0], ok.device)


def quarantine_mask(obs_raw: torch.Tensor, env_state) -> torch.Tensor:
    """The learner-side quarantine predicate: a row is healthy iff its
    observation AND its whole env-state row are finite."""
    return healthy_mask(obs_raw) & agent_health(env_state)


def portfolio_metrics(env: TradingEnv, env_state) -> dict[str, torch.Tensor]:
    """Mean/std over HEALTHY agents' portfolios (progressive), the same over
    agents whose cursor reached the horizon (``*_trained``, the reference's
    GetAvg observable), and the counts behind them."""
    values = env.portfolio_value(env_state)
    fine = agent_health(env_state).float()
    values = torch.where(fine > 0, values, torch.zeros_like(values))
    n_fine = torch.clamp(fine.sum(), min=1.0)
    mean = (values * fine).sum() / n_fine
    var = (fine * (values - mean) ** 2).sum() / n_fine
    done = fine * (env_state.t >= env.num_steps).float()
    n_done = done.sum()
    safe_n = torch.clamp(n_done, min=1.0)
    mean_t = (values * done).sum() / safe_n
    var_t = (done * (values - mean_t) ** 2).sum() / safe_n
    big = torch.finfo(torch.float32).max
    return {
        "portfolio_mean": mean,
        "portfolio_std": torch.sqrt(var),
        "portfolio_min": torch.where(fine > 0, values,
                                     torch.full_like(values, big)).min(),
        "portfolio_max": torch.where(fine > 0, values,
                                     torch.full_like(values, -big)).max(),
        "portfolio_mean_trained": mean_t,
        "portfolio_std_trained": torch.sqrt(var_t),
        "trained_workers": n_done,
        "unhealthy_workers": values.shape[0] - fine.sum(),
    }



# ---------------------------------------------------------------------------
# the chunk program (the JAX package's jitted step and megachunk_step)
# ---------------------------------------------------------------------------

def state_items(tree: Any, prefix: str = "") -> list[tuple[str, torch.Tensor]]:
    """Every tensor of a state tree (a ``TrainState``, draws) as ``(path,
    tensor)``, in a fixed order: dict keys sorted, named tuples and
    dataclasses by field, lists by index. Generators and other non-tensors
    are not leaves."""
    if isinstance(tree, torch.Tensor):
        return [(prefix, tree)]
    if isinstance(tree, dict):
        return [item for k in sorted(tree)
                for item in state_items(tree[k], f"{prefix}/{k}")]
    if hasattr(tree, "_fields"):
        return [item for f in tree._fields
                for item in state_items(getattr(tree, f), f"{prefix}/{f}")]
    if isinstance(tree, (list, tuple)):
        return [item for i, v in enumerate(tree)
                for item in state_items(v, f"{prefix}/{i}")]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [item for f in dataclasses.fields(tree)
                for item in state_items(getattr(tree, f.name),
                                        f"{prefix}/{f.name}")]
    return []


def with_tensors(tree: Any, tensors: dict[str, torch.Tensor],
                 prefix: str = "") -> Any:
    """A tree shaped like ``tree`` (new containers, generators and other
    non-tensors kept) whose tensor at each path is ``tensors[path]``."""
    if isinstance(tree, torch.Tensor):
        return tensors[prefix]
    if isinstance(tree, dict):
        return {k: with_tensors(tree[k], tensors, f"{prefix}/{k}")
                for k in sorted(tree)}
    if hasattr(tree, "_fields"):
        return type(tree)(*(with_tensors(getattr(tree, f), tensors,
                                         f"{prefix}/{f}")
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(with_tensors(v, tensors, f"{prefix}/{i}")
                          for i, v in enumerate(tree))
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return type(tree)(**{
            f.name: with_tensors(getattr(tree, f.name), tensors,
                                 f"{prefix}/{f.name}")
            for f in dataclasses.fields(tree)})
    return tree


def _same_storage(a: torch.Tensor, b: torch.Tensor) -> bool:
    return (a.data_ptr() == b.data_ptr() and a.shape == b.shape
            and a.stride() == b.stride() and a.dtype == b.dtype)


def _copy_into(dst: dict[str, torch.Tensor], src: list, what: str) -> None:
    """``dst[path].copy_(tensor)`` for every ``(path, tensor)`` of ``src``,
    skipping a tensor that already is its buffer; a path, shape or dtype
    that does not match raises ``ValueError``."""
    paths = [p for p, _ in src]
    if sorted(paths) != sorted(dst):
        raise ValueError(f"{what} does not match the chunk program's "
                         f"buffers: {sorted(set(paths) ^ set(dst))}")
    for path, t in src:
        buf = dst[path]
        if t.shape != buf.shape or t.dtype != buf.dtype:
            raise ValueError(
                f"{what}{path}: {t.dtype} {tuple(t.shape)} does not match "
                f"the chunk program's {buf.dtype} {tuple(buf.shape)}")
        if not _same_storage(t, buf):
            buf.copy_(t)


def _launch_counters() -> list[dict[str, int]]:
    from sharetrade_tpu_torch.ops import attention, fused_update
    return [attention.launch_counts, fused_update.launch_counts]


def _metric_vector(metrics: dict[str, Any], keys: tuple[str, ...],
                   device) -> torch.Tensor:
    """One chunk's metrics as a float64 ``(n,)`` tensor in ``keys`` order
    (float64 holds every int32 counter and float32 value exactly)."""
    if tuple(metrics) != keys:
        raise ValueError(f"the step's metrics {tuple(metrics)} changed from "
                         f"{keys}")
    return torch.stack([torch.as_tensor(metrics[k]).detach()
                        .to(device=device, dtype=torch.float64).reshape(())
                        for k in keys])


def _split_transitions(metrics: dict) -> tuple[dict, dict | None]:
    """A step's metrics without its ``transitions`` entry, and that entry
    (None when the agent collects none)."""
    if "transitions" not in metrics:
        return metrics, None
    metrics = dict(metrics)
    return metrics, metrics.pop("transitions")


@contextlib.contextmanager
def _gc_paused():
    """No automatic cyclic collection inside the block. A collection that
    fires on the capturing thread runs the finalizers of dead cycles (an
    earlier program's CUDA graph, pinned readback buffers, events), and
    their CUDA calls invalidate the capture; torch does not collect
    before a capture any more. Garbage waits for the next collection."""
    enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if enabled:
            gc.enable()


class StackedMetrics(NamedTuple):
    """One dispatch's per-chunk metrics: ``values`` (K, n) float64 in
    ``keys`` order, on the program's device, and, when the agent collects
    them, its transitions: per field a (K, T, B, ...) tensor. On the card
    the buffers are the program's own and the next dispatch overwrites
    them: read them back first (:meth:`ChunkProgram.readback`)."""

    keys: tuple[str, ...]
    values: torch.Tensor
    transitions: dict[str, torch.Tensor] | None = None


class MetricsReadback:
    """A dispatch's metric rows (and transitions) on their way to the host:
    on the card pinned buffers the copies were enqueued into, and the event
    recorded after them; :meth:`rows` and :meth:`transitions` wait on that
    event alone."""

    def __init__(self, keys: tuple[str, ...], host: torch.Tensor,
                 event=None, transitions: dict | None = None):
        self.keys, self._host, self._event = keys, host, event
        self._transitions = transitions

    def _wait(self) -> None:
        if self._event is not None:
            self._event.synchronize()

    def rows(self) -> list[dict[str, float]]:
        self._wait()
        return [dict(zip(self.keys, row)) for row in self._host.tolist()]

    def transitions(self) -> dict | None:
        """Per field a (K, T, B, ...) numpy array, or None."""
        if self._transitions is None:
            return None
        self._wait()
        return {k: v.numpy() for k, v in self._transitions.items()}


def _graph_nodes(graph) -> int | None:
    """Nodes of a captured graph kept with ``keep_graph``
    (``cuGraphGetNodes`` of ``libcuda``); None if the call fails."""
    count = ctypes.c_size_t(0)
    err = ctypes.CDLL("libcuda.so.1").cuGraphGetNodes(
        ctypes.c_void_p(graph.raw_cuda_graph()), None, ctypes.byref(count))
    return int(count.value) if err == 0 else None


class ChunkProgram:
    """The chunk as one program, dispatched ``k`` chunks at a time with no
    host readback in between: the port's counterpart of the JAX package's
    jitted ``agent.step`` and ``megachunk_step``.

    Every chunk's randomness comes from ``agent.draw`` (the seam a test
    hands other draws through). On the CPU a call steps eagerly. On the
    card:

    - the first chunk runs eagerly, on a side stream, as the capture's
      warm-up (autograd and cuBLAS set themselves up there);
    - the next dispatch captures ONE chunk, ``agent.step(ts, draws=...)``,
      in a ``torch.cuda.CUDAGraph`` over static buffers: a contiguous copy
      of every state tensor, the draw tensors, and a ``(n,)`` metric
      vector. The captured region ends by copying the new state into the
      state buffers, so the state lives in one set of buffers across
      replays (the learners update parameters, moments and DQN's replay in
      place: those are the buffers themselves);
    - every chunk after that takes its draws eagerly from the live
      generator (``agent.draw``: it advances exactly as in an eager step),
      copies them into the draw buffers, replays the graph and copies the
      metric vector into row k of a ``(K_max, n)`` buffer;
    - when the agent collects transitions, the tensors the captured step
      wrote them into are one more set of static buffers, and each replay
      copies them into slot k of a ``(K_max, T, B, ...)`` buffer per field
      (the warm-up chunk's likewise);
    - each kernel's launches in one replay are counted at capture (the
      wrappers count while the capture records, and those counts are taken
      back) and added to the wrappers' ``launch_counts`` on every replay.

    :meth:`load` puts a state into the buffers (a heal, a re-arm, a restore,
    a resume: every place that replaces the state calls it) and returns the
    live state, whose tensors ARE the buffers. Capture or replay errors
    raise; nothing falls back to eager steps.
    """

    def __init__(self, agent: Agent):
        self.agent = agent
        self.device = torch.device(agent.model.device)
        self.cuda = self.device.type == "cuda"
        self.keys: tuple[str, ...] | None = None
        self._warm = False
        self._graph = None
        self._buffers: dict[str, torch.Tensor] | None = None
        self._draws: dict[str, torch.Tensor] | None = None
        self._vector: torch.Tensor | None = None
        self._rows: torch.Tensor | None = None
        self._transitions: dict[str, torch.Tensor] | None = None
        self._tr_rows: dict[str, torch.Tensor] | None = None
        self._live: TrainState | None = None
        self._per_replay: list[tuple[dict, str, int]] = []
        #: Capture facts (the card): seconds to capture and instantiate,
        #: graph nodes, replays so far.
        self.capture_seconds: float | None = None
        self.nodes: int | None = None
        self.replays = 0

    @property
    def launches_per_replay(self) -> dict[str, int]:
        return {name: n for _, name, n in self._per_replay}

    def load(self, ts: TrainState) -> TrainState:
        """The live state holding ``ts``'s values: ``ts`` itself before the
        capture (and on the CPU); after it, the graph's buffers with
        ``ts`` copied in (on the current stream, so in order with the
        replays) and ``ts``'s generator."""
        if self._buffers is None or ts is self._live:
            return ts
        _copy_into(self._buffers, state_items(ts), "state")
        self._live = with_tensors(ts, self._buffers).replace(rng=ts.rng)
        return self._live

    def __call__(self, ts: TrainState, k: int = 1
                 ) -> tuple[TrainState, StackedMetrics]:
        if k < 1:
            raise ValueError(f"megachunk factor must be >= 1, got {k}")
        if not self.cuda:
            vectors, taken = [], []
            for _ in range(k):
                ts, metrics = self.agent.step(ts,
                                              draws=self.agent.draw(ts))
                metrics, transitions = _split_transitions(metrics)
                self.keys = self.keys or tuple(metrics)
                vectors.append(_metric_vector(metrics, self.keys,
                                              self.device))
                taken.append(transitions)
            stacked = (None if taken[0] is None else
                       {name: torch.stack([t[name] for t in taken])
                        for name in taken[0]})
            return ts, StackedMetrics(self.keys, torch.stack(vectors),
                                      stacked)
        ts = self.load(ts)
        for j in range(k):
            if not self._warm:
                ts, vector, transitions = self._warm_up(ts)
                self._rows_for(k)[j].copy_(vector)
                self._transitions_slot(k, j, transitions)
                continue
            if self._graph is None:
                ts = self._capture(ts)
            _copy_into(self._draws, state_items(self.agent.draw(ts)),
                       "draws")
            self._graph.replay()
            self.replays += 1
            for counts, name, n in self._per_replay:
                counts[name] += n
            self._rows_for(k)[j].copy_(self._vector)
            self._transitions_slot(k, j, self._transitions)
        return ts, StackedMetrics(
            self.keys, self._rows[:k],
            None if self._tr_rows is None
            else {name: t[:k] for name, t in self._tr_rows.items()})

    def readback(self, stacked: StackedMetrics) -> MetricsReadback:
        """Enqueue the copy of ``stacked`` to the host (before the next
        dispatch overwrites it): pinned buffers and one event after the
        copies on the card, the tensors as they are on the CPU."""
        if not self.cuda:
            return MetricsReadback(stacked.keys, stacked.values,
                                   transitions=stacked.transitions)

        def to_host(t: torch.Tensor) -> torch.Tensor:
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            host.copy_(t, non_blocking=True)
            return host

        host = to_host(stacked.values)
        transitions = (None if stacked.transitions is None else
                       {k: to_host(v) for k, v in stacked.transitions.items()})
        event = torch.cuda.Event()
        event.record()
        return MetricsReadback(stacked.keys, host, event, transitions)

    # ---- the card ---------------------------------------------------------

    def _rows_for(self, k: int) -> torch.Tensor:
        """The ``(K, n)`` metric rows, grown (never shrunk) to ``k``; rows
        already written in this dispatch are kept."""
        if self._rows is None or self._rows.shape[0] < k:
            rows = torch.zeros((k, len(self.keys)), dtype=torch.float64,
                               device=self.device)
            if self._rows is not None:
                rows[:self._rows.shape[0]].copy_(self._rows)
            self._rows = rows
        return self._rows

    def _transitions_slot(self, k: int, j: int,
                          transitions: dict | None) -> None:
        """Copy one chunk's transitions into slot ``j`` of the ``(K, T, B,
        ...)`` buffers, grown (never shrunk) to ``k``; slots already
        written in this dispatch are kept."""
        if transitions is None:
            return
        if (self._tr_rows is None
                or next(iter(self._tr_rows.values())).shape[0] < k):
            rows = {name: torch.zeros((k,) + t.shape, dtype=t.dtype,
                                      device=self.device)
                    for name, t in transitions.items()}
            if self._tr_rows is not None:
                for name, old in self._tr_rows.items():
                    rows[name][:old.shape[0]].copy_(old)
            self._tr_rows = rows
        for name, t in transitions.items():
            self._tr_rows[name][j].copy_(t)

    def _warm_up(self, ts: TrainState):
        """The run's first chunk, eagerly, on a side stream: the new state,
        its metric vector and its transitions (or None)."""
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            ts, metrics = self.agent.step(ts, draws=self.agent.draw(ts))
            metrics, transitions = _split_transitions(metrics)
            self.keys = tuple(metrics)
            vector = _metric_vector(metrics, self.keys, self.device)
        current.wait_stream(side)
        self._warm = True
        return ts, vector, transitions

    def _capture(self, ts: TrainState) -> TrainState:
        """Capture one chunk from ``ts``'s values; returns the live state."""
        items = state_items(ts)
        buffers = {p: t.clone(memory_format=torch.contiguous_format)
                   for p, t in items}
        # The draw buffers' shapes, from a copy of the generator: the live
        # one does not move for the capture.
        probe = torch.Generator(device=self.device)
        probe.set_state(ts.rng.get_state())
        draws = self.agent.draw(ts.replace(rng=probe))
        draw_buffers = {p: t.clone() for p, t in state_items(draws)}
        captured_ts = with_tensors(ts, buffers).replace(rng=probe)
        captured_draws = with_tensors(draws, draw_buffers)
        counters = _launch_counters()
        before = [dict(c) for c in counters]
        graph = torch.cuda.CUDAGraph(keep_graph=True)   # nodes countable
        torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        try:
            # thread_local: the readback consumer and the checkpoint writer
            # may wait on events from their own threads meanwhile.
            with _gc_paused(), torch.cuda.graph(
                    graph, capture_error_mode="thread_local"):
                new_ts, metrics = self.agent.step(captured_ts,
                                                  draws=captured_draws)
                _copy_into(buffers, state_items(new_ts), "the stepped state")
                metrics, transitions = _split_transitions(metrics)
                vector = _metric_vector(metrics, self.keys, self.device)
            graph.instantiate()
        finally:
            per_replay = []
            for counts, old in zip(counters, before):
                for name, n in counts.items():
                    if n != old[name]:
                        per_replay.append((counts, name, n - old[name]))
                    counts[name] = old[name]
        self.capture_seconds = time.perf_counter() - t0
        self.nodes = _graph_nodes(graph)
        self._graph, self._buffers, self._draws = graph, buffers, draw_buffers
        self._vector, self._per_replay = vector, per_replay
        self._transitions = transitions
        self._live = with_tensors(ts, buffers).replace(rng=ts.rng)
        return self._live
