"""DQN's journal-backed replay (``learner.journal_replay``) in the port's
orchestrator against the JAX package's, on the CPU.

Sizes as in tests/test_megachunk.py's journaled case: 72 prices (horizon
64), window 8, hidden 8, 4 agents, 8-step chunks (8 chunks, 256 rows),
replay capacity 4096, minibatch 8.

- Rows exactly once at K = 1, K = 4 and K = 4 with the async pipeline:
  the port, started from the JAX init (converted) and stepping on the JAX
  DQN step's own draws (per step ``rng, k_act, k_sample = split(rng, 3)``:
  the epsilon-greedy gates and random actions of ``k_act``, the uniform
  sample's ``randint`` of ``k_sample`` over the replay size after the
  push), journals the JAX orchestrator's records: the same count, rows per
  record and env-step stamps exactly, actions exactly, observations and
  rewards within 1e-5 relative plus 1e-5 x (1 + max |obs|) (a reward is a
  difference of portfolio values on the observations' scale); the
  journal's rows are the final replay buffer's bit for bit.
- ``--resume`` warm-starts the buffer to the journaled size, its rows the
  checkpointed buffer's bit for bit (under PER the sum-tree reseeded at
  the stored max priority); a fresh retrain on the same orchestrator
  truncates the journal and journals from its first chunk again; a
  supervised restart after a fault re-runs chunks without journaling them
  twice (stamps strictly increasing, rows = the buffer's size).
- The port warm-starts from a journal the JAX orchestrator wrote: resumed
  from the JAX final state (converted, saved as a port checkpoint), its
  buffer holds the JAX buffer's rows bit for bit.
- The journal's bound at ``2 x replay_capacity`` rows (capacity 64): in
  one file (compaction) and in 2-record segments (retirement), the same
  files, stamps and retirement counters as the JAX orchestrator's, and a
  resume warm-starts the newest rows.
- Legacy JSON ``transitions`` events fill a buffer as the JAX
  ``fill_replay_from_journal`` does.

Every journal and checkpoint sits under ``tmp_path``.
"""

import dataclasses
import functools
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sharetrade_tpu.agents import build_agent as jax_build_agent
from sharetrade_tpu.config import FrameworkConfig as JaxConfig
from sharetrade_tpu.env import trading as jtrading
from sharetrade_tpu.runtime import Orchestrator as JaxOrchestrator
from sharetrade_tpu_torch import convert
from sharetrade_tpu_torch.agents import dqn as tdqn
from sharetrade_tpu_torch.checkpoint import CheckpointManager
from sharetrade_tpu_torch.config import FrameworkConfig
from sharetrade_tpu_torch.data.journal import (
    iter_framed_records, segment_paths)
from sharetrade_tpu_torch.data.transitions import (
    decode_transitions, read_tail_transitions)
from sharetrade_tpu_torch.runtime import Orchestrator

WINDOW = 8
PRICES = np.linspace(10.0, 20.0, 72, dtype=np.float32)    # horizon 64
HORIZON = len(PRICES) - WINDOW
AGENTS = 4
ROWS = HORIZON * AGENTS


def fast_cfg(config_cls, tmp_path, tag, *, megachunk=1, async_on=False,
             **learner):
    cfg = config_cls()
    cfg.learner.algo = "dqn"
    cfg.learner.journal_replay = True
    cfg.learner.replay_capacity = 4096
    cfg.learner.replay_batch = 8
    for key, value in learner.items():
        setattr(cfg.learner, key, value)
    cfg.env.window = WINDOW
    cfg.model.hidden_dim = 8
    cfg.parallel.num_workers = AGENTS
    cfg.runtime.chunk_steps = 8
    cfg.runtime.checkpoint_every_updates = 64
    cfg.runtime.backoff_initial_s = 0.01
    cfg.runtime.backoff_max_s = 0.05
    cfg.runtime.metrics_every_chunks = 10
    cfg.runtime.megachunk_factor = megachunk
    cfg.runtime.async_pipeline = async_on
    cfg.runtime.checkpoint_dir = str(tmp_path / f"ckpts_{tag}")
    cfg.data.journal_dir = str(tmp_path / f"journal_{tag}")
    return cfg


def journal_path(cfg):
    return f"{cfg.data.journal_dir}/transitions.journal"


def records(path):
    """Every transition record, decoded, in order."""
    out = []
    for p in (*segment_paths(path), path):
        for _, payload in iter_framed_records(p):
            rec = decode_transitions(payload)
            if rec is not None:
                out.append(rec)
    return out


def run(orch, prices=PRICES, **send):
    orch.send_training_data(prices, **send)
    orch.start_training(background=False)
    assert orch.is_everything_done().state.value == "Completed"
    return orch


def assert_rows_are_the_buffer(path, replay):
    """The journal's rows, oldest first, are the buffer's first rows bit
    for bit (the buffer never wrapped), and no stamp repeats."""
    stamps = [r[4] for r in records(path)]
    assert stamps == sorted(set(stamps))
    tail = read_tail_transitions(path, 0)
    size = int(replay.size)
    assert tail[0].shape[0] == size
    for got, want in zip(tail[:4], (replay.obs, replay.action,
                                    replay.reward, replay.next_obs)):
        np.testing.assert_array_equal(got, want[:size].numpy())


# ---------------------------------------------------------------------------
# the JAX orchestrator's run and its draws
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnums=(2, 3))
def _jax_dqn_draws(rng, sizes, agents, batch):
    """One JAX DQN chunk's draws in its split order, given the replay size
    after each step's push; and the key after the chunk."""
    def body(rng, size):
        rng, k_act, k_sample = jax.random.split(rng, 3)
        pairs = jax.vmap(jax.random.split)(jax.random.split(k_act, agents))
        gate = jax.vmap(jax.random.uniform)(pairs[:, 0])
        rand = jax.vmap(lambda k: jax.random.randint(
            k, (), 0, 3, jnp.int32))(pairs[:, 1])
        idx = jax.random.randint(k_sample, (batch,), 0,
                                 jnp.maximum(size, 1))
        return rng, (gate, rand, idx)
    return jax.lax.scan(body, rng, sizes)


class JaxDqnDraws:
    """The port agent's ``draw`` replaced by the JAX run's keys (one
    episode: the init's key), the sizes from the chunk's start state (every
    agent active until the horizon)."""

    def __init__(self, key, cfg):
        self.key, self.cfg = key, cfg

    def __call__(self, ts):
        t0, size = int(ts.env_state.t[0]), int(ts.extras.replay.size)
        sizes = []
        for s in range(self.cfg.runtime.chunk_steps):
            if t0 + s < HORIZON:
                size = min(size + AGENTS, self.cfg.learner.replay_capacity)
            sizes.append(size)
        self.key, (gate, rand, idx) = _jax_dqn_draws(
            self.key, jnp.asarray(sizes, jnp.int32), AGENTS,
            self.cfg.learner.replay_batch)
        return tdqn.Draws(torch.tensor(np.asarray(gate)),
                          torch.tensor(np.asarray(rand)).long(),
                          torch.tensor(np.asarray(idx)))


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX orchestrator's journaled run: its config, init, journal
    records and final state (as numpy)."""
    tmp_path = tmp_path_factory.mktemp("jax")
    cfg = fast_cfg(JaxConfig, tmp_path, "jax")
    orch = JaxOrchestrator(cfg)
    run(orch)
    final = jax.tree.map(np.asarray, orch.train_state)
    orch.stop()
    jagent = jax_build_agent(cfg, jtrading.make_trading_env(
        PRICES, window=WINDOW, initial_budget=cfg.env.initial_budget))
    init = jax.tree.map(np.asarray, jagent.init(jax.random.PRNGKey(cfg.seed)))
    return {"cfg": cfg, "init": init, "final": final,
            "path": journal_path(cfg), "records": records(journal_path(cfg))}


def _port_on_jax_draws(tmp_path, jax_run, tag, **knobs):
    cfg = fast_cfg(FrameworkConfig, tmp_path, tag, **knobs)
    orch = Orchestrator(cfg, device="cpu")
    orch.send_training_data(PRICES, train_state=convert.train_state_from_jax(
        jax_run["init"]))
    orch._program.agent = dataclasses.replace(
        orch.agent, draw=JaxDqnDraws(jnp.asarray(jax_run["init"].rng), cfg))
    orch.start_training(background=False)
    assert orch.is_everything_done().state.value == "Completed"
    return cfg, orch


@pytest.mark.parametrize("megachunk,async_on", [(1, False), (4, False),
                                                (4, True)])
def test_rows_exactly_once_against_the_jax_orchestrator(tmp_path, jax_run,
                                                        megachunk, async_on):
    cfg, orch = _port_on_jax_draws(tmp_path, jax_run, "port",
                                   megachunk=megachunk, async_on=async_on)
    got, want = records(journal_path(cfg)), jax_run["records"]
    assert len(want) == HORIZON // cfg.runtime.chunk_steps
    assert [r[4] for r in got] == [r[4] for r in want]
    assert [len(r[1]) for r in got] == [len(r[1]) for r in want]
    assert sum(len(r[1]) for r in got) == ROWS
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[1], w[1])              # actions
        # A reward is a difference of two portfolio values, which sit on
        # the observations' scale (budget and shares ride the obs): its
        # float32 rounding is an ulp of that scale, not of the reward.
        scale = 1e-5 * (1 + float(np.abs(w[0]).max()))
        for name, a, b in (("obs", g[0], w[0]), ("reward", g[2], w[2]),
                           ("next_obs", g[3], w[3])):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=scale,
                                       err_msg=f"{name} at stamp {g[4]}")
    assert_rows_are_the_buffer(journal_path(cfg),
                               orch.train_state.extras.replay)
    jreplay = jax_run["final"].extras.replay
    assert int(orch.train_state.extras.replay.size) == int(jreplay.size)
    orch.stop()


# ---------------------------------------------------------------------------
# the port on its own: resume, retrain, restart
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("priority", ["uniform", "per"])
def test_resume_warm_starts_the_checkpointed_rows(tmp_path, priority):
    cfg = fast_cfg(FrameworkConfig, tmp_path, "r",
                   replay_priority=priority)
    orch = run(Orchestrator(cfg, device="cpu"))
    final = orch.train_state.extras
    orch.stop()
    resumed = Orchestrator(cfg, device="cpu")
    resumed.send_training_data(PRICES, resume=True)
    warm = resumed.train_state.extras
    assert int(warm.replay.size) == ROWS
    for name in ("obs", "action", "reward", "next_obs", "pos", "size"):
        assert torch.equal(getattr(warm.replay, name),
                           getattr(final.replay, name)), name
    if priority == "per":
        leaves = warm.per.tree.levels[0]
        assert torch.equal(leaves[:ROWS],
                           final.per.max_priority.expand(ROWS))
        assert float(leaves[ROWS:].abs().sum()) == 0.0
    resumed.stop()


def test_fresh_retrain_truncates_and_rejournals(tmp_path):
    cfg = fast_cfg(FrameworkConfig, tmp_path, "f")
    orch = run(Orchestrator(cfg, device="cpu"))
    first = records(journal_path(cfg))
    run(orch)                                  # a fresh run, same orch
    again = records(journal_path(cfg))
    assert [r[4] for r in again] == [r[4] for r in first]
    assert sum(len(r[1]) for r in again) == ROWS
    assert_rows_are_the_buffer(journal_path(cfg),
                               orch.train_state.extras.replay)
    orch.stop()


@pytest.mark.parametrize("megachunk", [1, 4])
def test_restart_after_a_fault_journals_nothing_twice(tmp_path, megachunk):
    fail_at = {5}

    def chaos(chunk_idx, row):
        if chunk_idx in fail_at:
            fail_at.discard(chunk_idx)
            raise RuntimeError("injected fault")

    cfg = fast_cfg(FrameworkConfig, tmp_path, "h", megachunk=megachunk)
    orch = run(Orchestrator(cfg, device="cpu", fault_hook=chaos))
    assert orch.restarts == 1 and not fail_at
    assert sum(len(r[1]) for r in records(journal_path(cfg))) == ROWS
    assert_rows_are_the_buffer(journal_path(cfg),
                               orch.train_state.extras.replay)
    # The re-run ends where an unfaulted run ends.
    plain = run(Orchestrator(fast_cfg(FrameworkConfig, tmp_path, "p"),
                             device="cpu"))
    for a, b in zip(tdqn.extras_tree(orch.train_state.extras)["replay"]
                    .values(),
                    tdqn.extras_tree(plain.train_state.extras)["replay"]
                    .values()):
        assert torch.equal(a, b)
    orch.stop()
    plain.stop()


def test_port_warm_starts_from_a_jax_journal(tmp_path, jax_run):
    cfg = fast_cfg(FrameworkConfig, tmp_path, "x")
    shutil.copytree(jax_run["cfg"].data.journal_dir, cfg.data.journal_dir)
    final = convert.train_state_from_jax(jax_run["final"])
    CheckpointManager(cfg.runtime.checkpoint_dir).save(
        int(final.updates), final, metadata={"episode": 0})
    orch = Orchestrator(cfg, device="cpu")
    orch.send_training_data(PRICES, resume=True)
    replay = orch.train_state.extras.replay
    jreplay = jax_run["final"].extras.replay
    size = int(jreplay.size)
    assert int(replay.size) == size == ROWS
    for name in ("obs", "action", "reward", "next_obs"):
        np.testing.assert_array_equal(getattr(replay, name)[:size].numpy(),
                                      np.asarray(getattr(jreplay,
                                                         name))[:size])
    # The JAX high-water stamp holds: nothing is journaled twice.
    assert orch._journal_high_water == jax_run["records"][-1][4]
    orch.stop()


# ---------------------------------------------------------------------------
# the journal's bound: compaction and segment retirement at the capacity
# ---------------------------------------------------------------------------

def _bounded_cfg(config_cls, tmp_path, tag, segments):
    cfg = fast_cfg(config_cls, tmp_path, tag, replay_capacity=64)
    # One write per append (no batching on a clock), so both packages
    # rotate and compact at the same appends.
    cfg.data.journal_fsync_every_records = 1
    cfg.data.journal_fsync_interval_s = 0.0
    cfg.data.journal_segment_records = segments
    return cfg


def _files(cfg):
    path = journal_path(cfg)
    return [(p.rsplit("/", 1)[-1], [r[4] for r in records_of(p)])
            for p in (*segment_paths(path), path)]


def records_of(path):
    return [rec for _, payload in iter_framed_records(path)
            if (rec := decode_transitions(payload)) is not None]


@pytest.mark.parametrize("segments", [0, 2])
def test_the_journal_is_bounded_like_the_reference(tmp_path, segments):
    """Capacity 64, 32 rows a chunk: every 64 new rows the journal keeps
    the records covering its newest 128 rows, rewritten in one file or,
    segmented (2 records a segment), by retiring whole old segments; the
    same files, stamps and retirement counters as the JAX orchestrator's."""
    jcfg = _bounded_cfg(JaxConfig, tmp_path, "jax", segments)
    jorch = run(JaxOrchestrator(jcfg))
    jorch.stop()
    cfg = _bounded_cfg(FrameworkConfig, tmp_path, "torch", segments)
    orch = run(Orchestrator(cfg, device="cpu"))
    assert _files(cfg) == _files(jcfg)
    stamps = [s for _, file_stamps in _files(cfg) for s in file_stamps]
    assert stamps == [40, 48, 56, 64]
    counters, jcounters = orch.metrics.counters(), jorch.metrics.counters()
    for name in ("journal_segments_retired_total",
                 "journal_compacted_bytes_total"):
        assert counters.get(name) == jcounters.get(name), name
    if segments:
        assert counters["journal_segments_retired_total"] == 2
        assert orch.metrics.series("journal_segments")[-1][1] == 3
    orch.stop()
    # A resume warm-starts the newest 64 rows.
    resumed = Orchestrator(cfg, device="cpu")
    resumed.send_training_data(PRICES, resume=True)
    replay = resumed.train_state.extras.replay
    tail = read_tail_transitions(journal_path(cfg), 64)
    assert int(replay.size) == 64
    np.testing.assert_array_equal(replay.obs.numpy(), tail[0][-64:])
    resumed.stop()


def test_legacy_json_events_fill_like_the_reference(tmp_path):
    """JSON ``transitions`` events (the format before the packed records):
    ``fill_replay_from_journal`` keeps the newest events that cover the
    capacity and pushes them oldest first, as the JAX function does."""
    from sharetrade_tpu.agents import dqn as jdqn
    from sharetrade_tpu.data.journal import Journal as JaxJournal
    from sharetrade_tpu_torch.data.journal import Journal

    rng = np.random.default_rng(5)
    events = []
    for i in range(5):
        rows = 7
        events.append({
            "type": "transitions", "env_steps": 8 * (i + 1),
            "obs": rng.standard_normal((rows, 6)).astype(np.float32).tolist(),
            "action": rng.integers(0, 3, rows).tolist(),
            "reward": rng.standard_normal(rows).astype(np.float32).tolist(),
            "next_obs": rng.standard_normal((rows, 6)).astype(
                np.float32).tolist()})
    path = str(tmp_path / "legacy.journal")
    with Journal(path) as j:
        for e in events:
            j.append(e)
        got = tdqn.fill_replay_from_journal(
            tdqn.ReplayBuffer.create(16, 6), j)
    with JaxJournal(path) as j:
        want = jdqn.fill_replay_from_journal(
            jdqn.ReplayBuffer.create(16, 6), j)
    for name in ("obs", "action", "reward", "next_obs", "pos", "size"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    assert int(got.size) == 16
