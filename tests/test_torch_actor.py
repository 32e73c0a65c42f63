"""The rollout actor (``distrib/actor.py``) in the port against the JAX
package's, on the CPU.

Size: 72 prices (a random walk at price scale 1 with a budget of 5, so the
policies trade), window 8, hidden 8, 4 agents, 12-step chunks, the epsilon
ramp over 20 env steps (random and greedy actions both run).

- The rollout chunk against JAX ``make_rollout_chunk`` from the same
  converted weights, with the JAX chunk's own draws recreated in its split
  order (per step ``rng, k_act = split(rng)``, ``split(k_act, B)``, per
  agent ``k_gate, k_rand = split(key)``), chunk after chunk through the
  port's chunk program across the horizon (a chunk whose last steps are
  frozen, then the env re-armed): actions, ``active``, the chunk-end
  ``env_steps`` and ``min_t`` exactly; obs, rewards and next_obs within
  1e-5 x (1 + max|x|).
- ``RolloutActor.run(max_chunks=2)``: its journal, read back by the JAX
  package's ``read_new_transitions``, is the port reader's row for row,
  every row of both chunks; a second actor on the same directory
  continues the stamps past the first one's high-water; a swap staged while
  a chunk runs is installed at the next chunk boundary only; the actor
  boots from ``tag_best`` (its ``params_step`` the tag's update count).
- ``cli actor --device cpu`` (the one subprocess): ``actor_ready``, a
  rolling heartbeat, SIGTERM drains to exit 75 with a ``drained`` heartbeat.
- On the CPU ``cli learner`` and ``cli actor`` split the host's cores
  between the learner and its actors (C14).
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time

import jax
import numpy as np
import torch

from sharetrade_tpu.agents import build_agent as jax_build_agent
from sharetrade_tpu.agents.base import batched_reset as jax_batched_reset
from sharetrade_tpu.config import FrameworkConfig as JaxConfig
from sharetrade_tpu.data.transitions import (
    read_new_transitions as jax_read_new_transitions)
from sharetrade_tpu.distrib.actor import make_rollout_chunk
from sharetrade_tpu.env import trading as jtrading
from sharetrade_tpu.precision import policy_from_config as jax_policy
from sharetrade_tpu_torch import convert
from sharetrade_tpu_torch.agents import build_agent
from sharetrade_tpu_torch.agents.base import (
    ChunkProgram, TrainState, batched_reset)
from sharetrade_tpu_torch.checkpoint import CheckpointManager
from sharetrade_tpu_torch.config import FrameworkConfig
from sharetrade_tpu_torch.data.transitions import read_new_transitions
from sharetrade_tpu_torch.distrib.actor import (
    HEARTBEAT_FILE, RolloutActor, make_rollout_agent, read_heartbeat)
from sharetrade_tpu_torch.env.trading import make_trading_env
from sharetrade_tpu_torch.precision import FP32

import test_torch_reference as ref

WINDOW, AGENTS, STEPS, BUDGET = 8, 4, 12, 5.0
PRICES = ref._prices(72, seed=3)
OVERRIDES = ["learner.algo=dqn", "model.kind=mlp", "model.hidden_dim=8",
             f"env.window={WINDOW}", f"env.initial_budget={BUDGET}",
             f"parallel.num_workers={AGENTS}",
             f"runtime.chunk_steps={STEPS}", "learner.epsilon_ramp_steps=20",
             "learner.replay_capacity=64", "learner.replay_batch=8"]
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _close(got, want, err_msg=""):
    ref._close(got, want, 1e-5, err_msg)


def _cfg(tmp_path, *extra):
    cfg = FrameworkConfig().apply_overrides(OVERRIDES + list(extra))
    cfg.runtime.checkpoint_dir = str(tmp_path / "ckpts")
    cfg.distrib.actor_dir = str(tmp_path / "actors")
    cfg.distrib.weight_poll_s = 0.0
    return cfg


def test_rollout_chunk_matches_jax_across_the_horizon():
    jcfg = JaxConfig().apply_overrides(OVERRIDES)
    jenv = jtrading.make_trading_env(PRICES, window=WINDOW,
                                     initial_budget=BUDGET)
    jagent = jax_build_agent(jcfg, jenv)
    jts = jagent.init(jax.random.PRNGKey(7))
    jchunk = make_rollout_chunk(jagent.model, jenv, jcfg.learner, AGENTS,
                                STEPS, jax_policy(jcfg.precision))
    tenv = make_trading_env(PRICES, window=WINDOW, initial_budget=BUDGET,
                            device="cpu")
    cfg = FrameworkConfig().apply_overrides(OVERRIDES)
    tmodel = build_agent(cfg, tenv, device="cpu").model
    params = convert.params_from_jax(jax.tree.map(np.asarray, jts.params))
    pending = []
    program = ChunkProgram(make_rollout_agent(
        tmodel, tenv, cfg.learner, AGENTS, STEPS, FP32,
        draw=lambda ts: pending.pop()))
    horizon = tenv.num_steps
    assert jenv.num_steps == horizon and horizon % STEPS != 0

    def fresh(env_steps):
        return TrainState(
            params=params, opt_state=None, carry={},
            env_state=batched_reset(tenv, AGENTS), rng=torch.Generator(),
            env_steps=torch.tensor(env_steps, dtype=torch.int32),
            updates=torch.zeros((), dtype=torch.int32))

    jenv_state, rng, jsteps = jax_batched_reset(jenv, AGENTS), \
        jax.random.PRNGKey(11), jax.numpy.int32(0)
    ts = fresh(0)
    chunks = -(-horizon // STEPS) + 2        # past the horizon, re-armed
    frozen = rearmed = 0
    actions = set()
    for c in range(chunks):
        rng_before = rng
        jenv_state, rng, jsteps, jmin_t, jtr = jchunk(
            jts.params, jenv_state, rng, jsteps)
        _, draws = ref.qlearn_draws(rng_before, STEPS)
        pending.append(draws)
        ts, stacked = program(ts)
        row = dict(zip(stacked.keys, stacked.values[0].tolist()))
        tr = {k: v[0].numpy() for k, v in stacked.transitions.items()}
        jobs, jact, jrew, jnext, jactive = (np.asarray(x) for x in jtr)
        np.testing.assert_array_equal(tr["valid"], jactive)
        np.testing.assert_array_equal(tr["action"], jact)
        assert row["env_steps"] == int(jsteps)
        assert row["min_t"] == int(jmin_t)
        _close(tr["obs"], jobs, f"obs, chunk {c}")
        _close(tr["reward"], jrew, f"reward, chunk {c}")
        _close(tr["next_obs"], jnext, f"next_obs, chunk {c}")
        frozen += int((~jactive).any())
        actions.update(np.unique(jact[jactive]).tolist())
        if int(jmin_t) >= horizon:             # re-arm, as the loop does
            rearmed += 1
            jenv_state = jax_batched_reset(jenv, AGENTS)
            ts = ts.replace(env_state=batched_reset(tenv, AGENTS))
    assert frozen >= 1 and rearmed == 1
    assert actions == {0, 1, 2}


def _actor(tmp_path, cfg=None, **kw):
    cfg = cfg or _cfg(tmp_path)
    return RolloutActor(cfg, PRICES, actor_id="a0",
                        workdir=os.path.join(cfg.distrib.actor_dir, "a0"),
                        device="cpu", **kw)


def _records(path):
    from sharetrade_tpu_torch.data.journal import (
        iter_framed_records, segment_paths)
    from sharetrade_tpu_torch.data.transitions import decode_transitions
    return [decode_transitions(p) for f in (*segment_paths(path), path)
            for _, p in iter_framed_records(f)]


def test_actor_journal_reads_back_in_jax_and_stamps_continue(tmp_path):
    actor = _actor(tmp_path)
    assert actor.params_step == 0            # no checkpoint: fresh init
    summary = actor.run(threading.Event(), max_chunks=2)
    assert summary["chunks"] == 2 and summary["env_steps"] == 2 * STEPS
    assert summary["rows_journaled"] == 2 * STEPS * AGENTS
    got = read_new_transitions(actor.journal_path, 0, 10_000)
    want = jax_read_new_transitions(actor.journal_path, 0, 10_000)
    assert got[4] == want[4] == 2 * STEPS
    for a, b in zip(got[:4], want[:4]):
        np.testing.assert_array_equal(a, b)
    assert got[0].shape == (2 * STEPS * AGENTS, WINDOW + 2)
    hb = read_heartbeat(actor.heartbeat_path)
    assert hb["phase"] == "drained" and hb["env_steps"] == 2 * STEPS
    # A restart recovers the high-water and stamps past it.
    again = _actor(tmp_path)
    again.run(threading.Event(), max_chunks=2)
    stamps = [r[4] for r in _records(actor.journal_path)]
    assert stamps == [STEPS, 2 * STEPS, 3 * STEPS, 4 * STEPS]
    new = jax_read_new_transitions(actor.journal_path, 2 * STEPS, 10_000)
    assert new[0].shape[0] == 2 * STEPS * AGENTS and new[4] == 4 * STEPS


def test_boot_from_tag_best_and_swap_only_at_a_chunk_boundary(tmp_path):
    from sharetrade_tpu_torch.agents.qlearn import chunk_draws, q_values
    cfg = _cfg(tmp_path)
    tenv = make_trading_env(PRICES, window=WINDOW, initial_budget=BUDGET,
                            device="cpu")
    learner = build_agent(cfg, tenv, device="cpu").init(3)
    CheckpointManager(cfg.runtime.checkpoint_dir).save_tagged(
        "best", learner, metadata={"updates": 9})
    # The new weights: the output columns rolled, so every greedy choice
    # moves to the next action.
    swapped = {k: dict(v) for k, v in learner.params.items()}
    swapped["layer2"]["w"] = torch.roll(swapped["layer2"]["w"], 1, dims=1)
    draws0 = chunk_draws(torch.Generator().manual_seed(0), STEPS, AGENTS, 3,
                         "cpu")
    box = []

    def draw(ts):
        # Gates of 0: greedy wherever the ramp allows it (env_steps > 0).
        if len(box) == 1:                    # chunk 1 is starting: stage
            box[0].swap_params(swapped, 17)
            box.append("staged")
        return type(draws0)(torch.zeros_like(draws0.gate),
                            draws0.random_action)

    actor = _actor(tmp_path, cfg, draw=draw)
    box.append(actor)
    assert actor.params_step == 9            # booted from tag_best
    for name, leaf in learner.params.items():
        for key, t in leaf.items():
            assert torch.equal(actor.params[name][key], t)
    actor.run(threading.Event(), max_chunks=2)
    assert actor.swaps_applied == 1 and actor.params_step == 17
    assert read_heartbeat(actor.heartbeat_path)["params_step"] == 17
    for rec, params in zip(_records(actor.journal_path),
                           (learner.params, swapped)):
        obs, action = torch.tensor(rec[0]), rec[1]
        greedy = q_values(actor.model, params, obs).argmax(-1).numpy()
        # Chunk 1 ran the old weights to its end, chunk 2 the new ones
        # (the first row of chunk 1 is at env_steps 0: random).
        np.testing.assert_array_equal(action[AGENTS:], greedy[AGENTS:])
    other = q_values(actor.model, swapped, torch.tensor(
        _records(actor.journal_path)[0][0])).argmax(-1).numpy()
    assert (other[AGENTS:] != _records(actor.journal_path)[0][1][AGENTS:]
            ).any()


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def test_cli_actor_on_the_cpu_rolls_and_drains(tmp_path):
    cmd = [sys.executable, "-m", "sharetrade_tpu_torch.cli", "actor",
           "--device", "cpu", "--actor-id", "a7",
           "--set", "data.synthetic_length=72",
           "--set", "distrib.heartbeat_interval_s=0.05",
           "--set", "distrib.weight_poll_s=0"]
    for item in OVERRIDES:
        cmd += ["--set", item]
    proc = subprocess.Popen(cmd, cwd=tmp_path, env=_env(),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    hb_path = tmp_path / "actors" / "a7" / HEARTBEAT_FILE
    try:
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            hb = read_heartbeat(str(hb_path))
            if hb and hb["phase"] == "rolling" and hb["chunks"] >= 2:
                break
            assert proc.poll() is None, proc.stderr.read()
            time.sleep(0.05)
        else:
            raise AssertionError("the actor never reached the rolling phase")
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 75, err
    lines = [json.loads(x) for x in out.splitlines() if x.startswith("{")]
    assert lines[0]["event"] == "actor_ready" and lines[0]["device"] == "cpu"
    assert lines[-1]["actor_id"] == "a7" and lines[-1]["chunks"] >= 2
    hb = read_heartbeat(str(hb_path))
    assert hb["phase"] == "drained"
    assert hb["env_steps"] == lines[-1]["env_steps"]
    out = read_new_transitions(str(tmp_path / "actors" / "a7" /
                                   "transitions.journal"), 0, 100_000)
    assert out[4] == lines[-1]["env_steps"]


def test_cli_processes_share_the_host_cores_on_the_cpu():
    """A CPU learner and its actors split the intra-op threads between
    them (a thread per core in every process oversubscribed the host: a
    full-width DQN chunk beside two actors took more than 35 s, 0.6-1.3 s
    alone); a CUDA run keeps torch's default."""
    from sharetrade_tpu_torch import cli
    before = torch.get_num_threads()
    cores = len(os.sched_getaffinity(0))
    try:
        cli._share_host_cores(torch.device("cpu"), 3)
        assert torch.get_num_threads() == max(1, cores // 3)
        cli._share_host_cores(torch.device("cpu"), 10 * cores)
        assert torch.get_num_threads() == 1
        torch.set_num_threads(before)
        cli._share_host_cores(torch.device("cuda"), 3)
        assert torch.get_num_threads() == before
    finally:
        torch.set_num_threads(before)
