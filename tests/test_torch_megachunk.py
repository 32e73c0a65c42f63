"""Megachunks, sampled readback and the async pipeline of the port's
orchestrator, on the CPU, held against themselves and against the JAX
package's orchestrator.

Sizes as in tests/test_async_pipeline.py and tests/test_megachunk.py:
window 8, hidden 8, 4 workers, 16-step chunks, a 256-step episode (a
512-step one for double buffering, 64 steps for the K=1 fallback).

- Port against port, bit for bit: K=4 and the async pipeline against K=1
  with the pipeline off (final state and generator, the per-chunk metric
  stream, GetAvg), Q-learning and one DQN case; K=8 over a 64-step episode
  against K=1.
- Port against the JAX orchestrator, the same knobs (K=4, async, a sample
  every 3 chunks) and the same draws: the JAX Q-learning step's
  epsilon-greedy draws, recreated in its split order from the keys its
  orchestrator threads (``agent.init(PRNGKey(seed + episode))`` at each
  re-arm), go into the port through the agent's ``draw`` seam, and the port
  starts from the JAX init's converted state. Final avg/std within the
  tolerance of tests/test_torch_reference.py (1e-5 relative), and
  ``env_steps``, ``updates``, ``chunks_timed`` and the sequence of
  ``episode_completed`` / ``checkpoint`` / ``training_completed`` events
  equal.
- Completion never overshoots (2 episodes, K=8, a sample every 1000
  chunks), in both packages.
- Supervision at megachunk granularity: a fault-hook fault on inner chunk
  2 fires with its true index and is retried there; a heal under double
  buffering is not repeated on the stale rows of the megachunk in flight;
  an always-failing hook spends the same restart budget with the same
  events as the JAX orchestrator, pipeline on; a preemption mid-run drains
  the pipeline, and the resumed run ends bit-equal to an uninterrupted one.
- The chunk program pauses the cyclic collector for the length of its
  capture and leaves it as it found it (the card's capture test is in
  tests/test_torch_cuda.py).
"""

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sharetrade_tpu.agents import build_agent as jax_build_agent
from sharetrade_tpu.config import FrameworkConfig as JaxConfig
from sharetrade_tpu.env import trading as jtrading
from sharetrade_tpu.runtime import Orchestrator as JaxOrchestrator
from sharetrade_tpu.utils.logging import EventLog as JaxEventLog
from sharetrade_tpu_torch import convert
from sharetrade_tpu_torch.agents import qlearn as tqlearn
from sharetrade_tpu_torch.agents.base import state_items
from sharetrade_tpu_torch.config import FrameworkConfig
from sharetrade_tpu_torch.runtime import Orchestrator, Phase, ReplyState
from sharetrade_tpu_torch.utils.logging import EventLog

WINDOW = 8
PRICES = np.linspace(10.0, 20.0, 264, dtype=np.float32)         # horizon 256
LONG_PRICES = np.linspace(10.0, 20.0, 520, dtype=np.float32)    # 512
SHORT_PRICES = np.linspace(10.0, 20.0, 72, dtype=np.float32)    # 64
DETERMINISTIC_KEYS = ("loss", "env_steps", "updates", "reward_sum",
                      "portfolio_mean", "portfolio_std")


def fast_cfg(config_cls, tmp_path, tag, *, megachunk=1, async_on=False,
             algo="qlearn", every=1, **runtime):
    cfg = config_cls()
    cfg.learner.algo = algo
    cfg.env.window = WINDOW
    cfg.model.hidden_dim = 8
    cfg.parallel.num_workers = 4
    cfg.runtime.chunk_steps = 16
    cfg.runtime.checkpoint_every_updates = 64
    cfg.runtime.checkpoint_dir = str(tmp_path / f"ckpts_{tag}")
    cfg.runtime.backoff_initial_s = 0.01
    cfg.runtime.backoff_max_s = 0.05
    cfg.runtime.max_restarts = 3
    cfg.runtime.metrics_every_chunks = every
    cfg.runtime.megachunk_factor = megachunk
    cfg.runtime.async_pipeline = async_on
    if algo == "dqn":
        cfg.runtime.chunk_steps = 8
        cfg.learner.replay_capacity = 4096
        cfg.learner.replay_batch = 8
    for key, value in runtime.items():
        setattr(cfg.runtime, key, value)
    return cfg


def run_port(cfg, prices=PRICES, *, events=None, **kw):
    orch = Orchestrator(cfg, device="cpu", event_log=events, **kw)
    orch.send_training_data(prices)
    orch.start_training(background=False)
    orch.stop()
    return orch


def assert_same_state(a, b):
    got, want = state_items(a.train_state), state_items(b.train_state)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, x), (_, y) in zip(got, want):
        assert torch.equal(x, y), path
    assert torch.equal(a.train_state.rng.get_state(),
                       b.train_state.rng.get_state())


def series(orch, key):
    return [v for _, v in orch.metrics.series(key)]


# ---------------------------------------------------------------------------
# port against port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("algo,k,async_on", [
    ("qlearn", 4, False), ("qlearn", 1, True), ("qlearn", 4, True),
    ("dqn", 4, True)])
def test_megachunks_and_pipeline_bitwise_equal_k1_sync(tmp_path, algo, k,
                                                        async_on):
    prices = SHORT_PRICES if algo == "dqn" else PRICES
    base = run_port(fast_cfg(FrameworkConfig, tmp_path, "base", algo=algo),
                    prices)
    other = run_port(fast_cfg(FrameworkConfig, tmp_path, "other", algo=algo,
                              megachunk=k, async_on=async_on), prices)
    for orch in (base, other):
        assert orch.is_everything_done().state is ReplyState.COMPLETED
        assert orch.restarts == 0
    assert_same_state(base, other)
    for key in DETERMINISTIC_KEYS:
        assert series(base, key) == series(other, key), key
    assert base.get_avg().value == other.get_avg().value
    assert base.get_std().value == other.get_std().value
    if async_on:
        stats = other.pipeline_stats
        assert stats["boundaries"] > 0
        assert stats["max_depth_seen"] <= 2


def test_factor_longer_than_the_episode_falls_back_to_k1(tmp_path):
    """K x chunk_steps >= horizon: every dispatch takes the K=1 path, and
    the run equals K=1."""
    base = run_port(fast_cfg(FrameworkConfig, tmp_path, "k1"), SHORT_PRICES)
    fb = run_port(fast_cfg(FrameworkConfig, tmp_path, "k8", megachunk=8,
                           async_on=True), SHORT_PRICES)
    assert fb.is_everything_done().state is ReplyState.COMPLETED
    assert_same_state(base, fb)
    assert series(base, "env_steps") == series(fb, "env_steps")


# ---------------------------------------------------------------------------
# port against the JAX orchestrator
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnums=(1, 2, 3))
def _jax_qlearn_draws(rng, steps, agents, actions):
    """A JAX Q-learning chunk's epsilon-greedy draws, in its split order
    (per step ``rng, k_act = split(rng)``, ``split(k_act, B)``, per agent
    ``k_gate, k_rand = split(key)``), and the key after the chunk."""
    def body(rng, _):
        rng, k_act = jax.random.split(rng)
        pairs = jax.vmap(jax.random.split)(jax.random.split(k_act, agents))
        gate = jax.vmap(jax.random.uniform)(pairs[:, 0])
        rand = jax.vmap(lambda k: jax.random.randint(
            k, (), 0, actions, jnp.int32))(pairs[:, 1])
        return rng, (gate, rand)
    return jax.lax.scan(body, rng, None, length=steps)


class JaxDraws:
    """The port agent's ``draw`` replaced by the JAX orchestrator's keys:
    each episode starts from ``agent.init(PRNGKey(seed + episode)).rng``,
    and each chunk advances the key as the JAX step does."""

    def __init__(self, orch, jagent, cfg):
        self.orch, self.jagent, self.cfg = orch, jagent, cfg
        self.episode, self.key = None, None

    def __call__(self, ts):
        if self.orch.episode != self.episode:
            self.episode = self.orch.episode
            self.key = self.jagent.init(
                jax.random.PRNGKey(self.cfg.seed + self.episode)).rng
        self.key, (gate, rand) = _jax_qlearn_draws(
            self.key, self.cfg.runtime.chunk_steps,
            self.cfg.parallel.num_workers, 3)
        return tqlearn.Draws(torch.tensor(np.asarray(gate)),
                             torch.tensor(np.asarray(rand)).long())


def run_pair(tmp_path, prices, **knobs):
    """The same run through both orchestrators; returns them and their
    event lists."""
    out = {}
    jcfg = fast_cfg(JaxConfig, tmp_path, "jax", **knobs)
    path = tmp_path / "jax-events.jsonl"
    jevents = JaxEventLog(str(path))
    jorch = JaxOrchestrator(jcfg, event_log=jevents)
    jorch.send_training_data(prices)
    jorch.start_training(background=False)
    jorch.stop()
    jevents.close()
    out["jax"] = jorch, [json.loads(line) for line in open(path)]

    cfg = fast_cfg(FrameworkConfig, tmp_path, "torch", **knobs)
    path = tmp_path / "torch-events.jsonl"
    events = EventLog(str(path))
    jagent = jax_build_agent(jcfg, jtrading.make_trading_env(
        prices, window=WINDOW, initial_budget=jcfg.env.initial_budget))
    init = convert.train_state_from_jax(jax.tree.map(
        np.asarray, jagent.init(jax.random.PRNGKey(cfg.seed))))
    orch = Orchestrator(cfg, device="cpu", event_log=events)
    orch.send_training_data(prices, train_state=init)
    orch._program.agent = dataclasses.replace(
        orch.agent, draw=JaxDraws(orch, jagent, cfg))
    orch.start_training(background=False)
    orch.stop()
    events.close()
    out["torch"] = orch, [json.loads(line) for line in open(path)]
    return out


KINDS = ("episode_completed", "checkpoint", "training_completed")


def _events(events):
    keep = []
    for e in events:
        if e["kind"] in KINDS:
            keep.append({k: e[k] for k in ("kind", "episode", "updates",
                                           "env_steps", "episodes",
                                           "chunks_timed") if k in e})
    return keep


def test_port_matches_the_jax_orchestrator_k4_async_every_3(tmp_path):
    runs = run_pair(tmp_path, PRICES, megachunk=4, async_on=True, every=3,
                    episodes=2)
    (jorch, jevents), (torch_orch, tevents) = runs["jax"], runs["torch"]
    for orch in (jorch, torch_orch):
        assert orch.is_everything_done().state.value == "Completed"
        assert orch.restarts == 0
    want, got = _events(jevents), _events(tevents)
    assert got == want
    assert [e["kind"] for e in got].count("episode_completed") == 1
    done = got[-1]
    assert done["kind"] == "training_completed"
    assert done["env_steps"] == 2 * (len(PRICES) - WINDOW)
    assert done["chunks_timed"] == 2 * 16
    jsnap, tsnap = jorch.snapshot(), torch_orch.snapshot()
    assert tsnap["env_steps"] == jsnap["env_steps"]
    assert tsnap["updates"] == jsnap["updates"]
    for query in ("get_avg", "get_std"):
        want = getattr(jorch, query)().value
        got = getattr(torch_orch, query)().value
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-5 * (1 + abs(want)))


def test_completion_never_overshoots_in_both(tmp_path):
    """Two episodes under K=8 with a sample every 1000 chunks: the upper
    bound falls back to single chunks near each threshold, so each run
    completes at exactly 2 x horizon env steps with the K=1 chunk count."""
    runs = run_pair(tmp_path, PRICES, megachunk=8, async_on=True,
                    every=1000, episodes=2)
    horizon = len(PRICES) - WINDOW
    for pkg, (orch, events) in runs.items():
        assert orch.is_everything_done().state.value == "Completed", pkg
        done = [e for e in events if e["kind"] == "training_completed"][0]
        assert done["env_steps"] == 2 * horizon, pkg
        assert done["chunks_timed"] == 2 * -(-horizon // 16), pkg
    assert _events(runs["torch"][1]) == _events(runs["jax"][1])


def test_restart_budget_matches_jax_with_the_pipeline_on(tmp_path):
    def always(exc):
        def hook(chunk_idx, row):
            raise exc("always")
        return hook

    kinds = {}
    for pkg, (cfg_cls, orch_cls, log_cls, kw) in {
            "jax": (JaxConfig, JaxOrchestrator, JaxEventLog, {}),
            "torch": (FrameworkConfig, Orchestrator, EventLog,
                      {"device": "cpu"})}.items():
        cfg = fast_cfg(cfg_cls, tmp_path, pkg, megachunk=4, async_on=True)
        path = tmp_path / f"{pkg}-budget.jsonl"
        events = log_cls(str(path))
        orch = orch_cls(cfg, event_log=events,
                        fault_hook=always(RuntimeError), **kw)
        orch.send_training_data(PRICES)
        orch.start_training(background=False)
        orch.stop()
        events.close()
        kinds[pkg] = (orch.restarts, orch.lifecycle.phase.value,
                      [json.loads(line)["kind"] for line in open(path)])
    assert kinds["torch"] == kinds["jax"]
    assert kinds["torch"][0] == 4 and kinds["torch"][1] == "failed"


# ---------------------------------------------------------------------------
# supervision at megachunk granularity
# ---------------------------------------------------------------------------

def test_fault_mid_megachunk_fires_with_its_true_chunk_index(tmp_path):
    seen, fired = [], []

    def chaos(chunk_idx, row):
        seen.append(chunk_idx)
        if chunk_idx == 2 and not fired:
            fired.append(1)
            raise RuntimeError("injected mid-megachunk")

    orch = run_port(fast_cfg(FrameworkConfig, tmp_path, "chaos", megachunk=4,
                             async_on=True), fault_hook=chaos)
    assert orch.is_everything_done().state is ReplyState.COMPLETED
    assert orch.restarts == 1
    # Inner chunks 0 and 1 came from the stacked rows, the fault fired at
    # index 2, and the restored loop retried chunk 2, not 4.
    assert seen[:4] == [0, 1, 2, 2]


def test_heal_under_double_buffering_is_not_repeated(tmp_path):
    """Double buffering keeps one megachunk in flight past the boundary
    that heals a poisoned row; its rows, computed before the heal, still
    report the row. They must not heal again: one heal, no restart."""
    cfg = fast_cfg(FrameworkConfig, tmp_path, "db", megachunk=8,
                   double_buffer_dispatch=True)
    orch = Orchestrator(cfg, device="cpu")
    orch.send_training_data(LONG_PRICES)
    ts = orch._ts
    budget = ts.env_state.budget.clone()
    budget[2] = float("nan")
    orch._ts = ts.replace(env_state=ts.env_state.replace(budget=budget))
    orch.start_training(background=False)
    orch.stop()
    assert orch.is_everything_done().state is ReplyState.COMPLETED
    assert orch.agent_heals == 1
    assert orch.restarts == 0
    assert orch.snapshot()["unhealthy_workers"] == 0
    # The healed row restarted its episode after the megachunk in flight:
    # 2 x 8 chunks, then a whole episode more.
    assert int(orch.train_state.env_steps) == 2 * 8 * 16 + 512


def test_double_buffering_is_bitwise_the_plain_path(tmp_path):
    plain = run_port(fast_cfg(FrameworkConfig, tmp_path, "plain",
                              megachunk=8), LONG_PRICES)
    buffered = run_port(fast_cfg(FrameworkConfig, tmp_path, "buffered",
                                 megachunk=8, double_buffer_dispatch=True),
                        LONG_PRICES)
    assert buffered.is_everything_done().state is ReplyState.COMPLETED
    assert_same_state(plain, buffered)
    assert series(plain, "loss") == series(buffered, "loss")


def test_preempt_drains_the_pipeline_and_resumes_bitwise(tmp_path):
    knobs = dict(megachunk=4, async_on=True, every=3)
    straight = run_port(fast_cfg(FrameworkConfig, tmp_path, "straight",
                                 **knobs))
    cfg = fast_cfg(FrameworkConfig, tmp_path, "cut", **knobs)
    orch = Orchestrator(cfg, device="cpu")
    orch.send_training_data(PRICES)
    draw = orch.agent.draw
    dispatched = []

    def preempt_at_chunk_6(ts):
        dispatched.append(1)
        if len(dispatched) == 6:
            orch.request_preempt()
        return draw(ts)

    orch._program.agent = dataclasses.replace(orch.agent,
                                              draw=preempt_at_chunk_6)
    orch.start_training(background=False)
    orch.stop()
    assert orch.preempted and orch.preempt_saved
    assert orch.lifecycle.phase is Phase.TRAINING
    meta = orch.checkpoints.tagged_metadata("preempt")
    assert meta["env_steps"] == 16 * len(dispatched)
    # Every boundary put before the preemption was consumed.
    assert orch.pipeline_stats["boundaries"] >= 1
    assert orch.chunks == orch._committed_idx
    resumed = Orchestrator(cfg, device="cpu")
    resumed.send_training_data(PRICES, resume=True)
    resumed.start_training(background=False)
    resumed.stop()
    assert resumed.is_everything_done().state is ReplyState.COMPLETED
    assert_same_state(straight, resumed)


@pytest.mark.parametrize("enabled", [True, False])
def test_capture_pauses_the_cyclic_collector(enabled):
    """``_gc_paused``, which the chunk program's capture runs under: no
    automatic collection inside, the collector's state as before after it,
    also when the block raises."""
    import gc

    from sharetrade_tpu_torch.agents.base import _gc_paused

    was = gc.isenabled()
    (gc.enable if enabled else gc.disable)()
    try:
        with _gc_paused():
            assert not gc.isenabled()
        assert gc.isenabled() is enabled
        with pytest.raises(KeyError):
            with _gc_paused():
                raise KeyError("inside")
        assert gc.isenabled() is enabled
    finally:
        (gc.enable if was else gc.disable)()
