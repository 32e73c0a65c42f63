"""DQN and its sum-tree in the port against the JAX package's, on the CPU.

- ``ops/sum_tree``: a priority update (duplicate indices and a mask
  included), the total and a stratified sample against the JAX module on
  the same uniforms: sampled indices equal, priorities and probabilities
  within 1e-6 relative; the importance-sampling weights within 1e-6.
- One DQN chunk pair, uniform and PER, from the JAX init converted to the
  port, with the JAX step's own draws (per step ``rng, k_act, k_sample =
  split(rng, 3)``: the epsilon-greedy draws of ``k_act`` as in
  Q-learning, and from ``k_sample`` the uniform sample's ``randint``
  indices or PER's strata uniforms). Replay contents, write position and
  size, the update count (the target sync follows it), params, target
  params and the PER tree and max priority agree: counters, actions and
  positions exactly; observations, params and priorities within
  1e-5 x (1 + max|leaf|). The replay wraps (capacity 64, 4 agents, 2 x 12
  steps) and the target syncs (every 5 updates).
- A DQN state (uniform and PER) round-trips through the port's checkpoint
  ``state.npz`` bit for bit, and a JAX DQN state converts
  (``convert.train_state_from_jax``) into the port's layout, extras
  included (the chunk pairs above start from such a conversion).

``learner.journal_replay`` (the transition journal and its warm start) is
held in tests/test_torch_journal_replay.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sharetrade_tpu.ops import sum_tree as jtree
from sharetrade_tpu_torch import convert
from sharetrade_tpu_torch.agents import dqn as tdqn
from sharetrade_tpu_torch.checkpoint import CheckpointManager
from sharetrade_tpu_torch.config import FrameworkConfig
from sharetrade_tpu_torch.ops import sum_tree as ttree

import test_torch_reference as ref

DQN = ["learner.replay_capacity=64", "learner.replay_batch=8",
       "learner.target_update_every=5"]


def _close(got, want, rtol=1e-5, err_msg=""):
    ref._close(got, want, rtol, err_msg)


# ---------------------------------------------------------------------------
# the sum-tree
# ---------------------------------------------------------------------------

def test_sum_tree_matches_jax():
    rng = np.random.default_rng(0)
    idx = rng.integers(0, 20, 12).astype(np.int32)
    idx[3] = idx[7]                       # a duplicate index
    prio = rng.uniform(0.1, 2.0, 12).astype(np.float32)
    prio[7] = prio[3]                     # writing the same value twice
    mask = rng.uniform(size=12) > 0.25
    jt = jtree.set_priorities(jtree.create(20), jnp.asarray(idx),
                              jnp.asarray(prio), jnp.asarray(mask))
    tt = ttree.set_priorities(ttree.create(20), torch.from_numpy(idx),
                              torch.from_numpy(prio), torch.from_numpy(mask))
    assert tt.num_leaves == jt.num_leaves == 32
    for a, b in zip(tt.levels, jt.levels):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
    np.testing.assert_allclose(float(tt.total), float(jt.total), rtol=1e-6)
    key = jax.random.PRNGKey(4)
    u = np.asarray(jax.random.uniform(key, (16,)))
    jidx, jprobs = jtree.sample_stratified(jt, key, 16)
    tidx, tprobs = ttree.sample_stratified(tt, torch.from_numpy(u.copy()))
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(tprobs.numpy(), np.asarray(jprobs), rtol=1e-6)
    assert bool((tt.leaves[tidx] > 0).all())
    size, beta = 12, 0.55
    np.testing.assert_allclose(
        ttree.is_weights(tprobs, torch.tensor(size), torch.tensor(beta)),
        np.asarray(jtree.is_weights(jprobs, jnp.int32(size),
                                    jnp.float32(beta))), rtol=1e-6)
    # An all-zero tree samples index 0 with probability 0.
    zidx, zprobs = ttree.sample_stratified(ttree.create(8), torch.rand(4))
    assert zidx.tolist() == [0] * 4 and zprobs.tolist() == [0.0] * 4


def test_reseed_per_priorities_matches_jax():
    from sharetrade_tpu.agents import dqn as jdqn
    pair = ref._Pair("dqn", *DQN, "learner.replay_priority=per")
    jextras = pair.jts.extras.replace(replay=pair.jts.extras.replay.replace(
        size=jnp.int32(13)))
    textras = tdqn.DQNExtras(
        target_params=pair.tts.extras.target_params,
        replay=tdqn.ReplayBuffer(**{
            **pair.tts.extras.replay.__dict__,
            "size": torch.tensor(13, dtype=torch.int32)}),
        per=pair.tts.extras.per)
    jout = jdqn.reseed_per_priorities(jextras, priority=2.5)
    tout = tdqn.reseed_per_priorities(textras, priority=2.5)
    for a, b in zip(tout.per.tree.levels, jout.per.tree.levels):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# ---------------------------------------------------------------------------
# the DQN step
# ---------------------------------------------------------------------------

def dqn_draws(jts, steps, *, per: bool, horizon: int, capacity=64,
              batch=8):
    """The JAX DQN step's draws for ``steps`` steps from ``jts``: the
    uniform sample's indices follow the replay size after each push (every
    agent active until the horizon)."""
    rng, size = jts.rng, int(jts.extras.replay.size)
    t = int(jts.env_state.t[0])
    gate, rand, sample = [], [], []
    for _ in range(steps):
        rng, k_act, k_sample = jax.random.split(rng, 3)
        pairs = [jax.random.split(k)
                 for k in jax.random.split(k_act, ref.AGENTS)]
        gate.append([float(jax.random.uniform(k)) for k, _ in pairs])
        rand.append([int(jax.random.randint(k, (), 0, 3, jnp.int32))
                     for _, k in pairs])
        if t < horizon:
            size = min(size + ref.AGENTS, capacity)
        t += 1
        if per:
            sample.append(np.asarray(jax.random.uniform(k_sample, (batch,))))
        else:
            sample.append(np.asarray(jax.random.randint(
                k_sample, (batch,), 0, jnp.maximum(jnp.int32(size), 1))))
    return tdqn.Draws(torch.tensor(gate, dtype=torch.float32),
                      torch.tensor(rand, dtype=torch.int64),
                      torch.from_numpy(np.stack(sample)))


def _assert_same_dqn_state(t, jts):
    """``t``: the port's state as numpy (``train_state_to_numpy``)."""
    jx = jts.extras
    tx = t["extras"]
    for name in ("action", "pos", "size"):
        np.testing.assert_array_equal(tx["replay"][name],
                                      np.asarray(getattr(jx.replay, name)),
                                      err_msg=name)
    for name in ("obs", "reward", "next_obs"):
        _close(tx["replay"][name], getattr(jx.replay, name), err_msg=name)
    assert int(t["updates"]) == int(jts.updates)
    assert int(t["env_steps"]) == int(jts.env_steps)
    for field in ("t", "shares"):
        np.testing.assert_array_equal(t["env_state"][field],
                                      np.asarray(getattr(jts.env_state,
                                                         field)))
    for part, jpart in (("params", jts.params),
                        ("target", jx.target_params)):
        tpart = t["params"] if part == "params" else tx["target_params"]
        for a, b in zip(jax.tree.leaves(tpart), jax.tree.leaves(jpart)):
            _close(a, b, err_msg=part)
    for a, b in zip(jax.tree.leaves(t["opt_state"][0].sum_of_squares),
                    jax.tree.leaves(jts.opt_state[0].sum_of_squares)):
        _close(a, b, err_msg="sum_of_squares")
    if "per" in tx:
        for a, b in zip(tx["per"]["tree"], jx.per.tree.levels):
            _close(a, b, err_msg="per tree")
        _close(tx["per"]["max_priority"], jx.per.max_priority,
               err_msg="max priority")


@pytest.mark.parametrize("priority", ["uniform", "per"])
def test_dqn_chunks_match_jax(priority):
    pair = ref._Pair("dqn", *DQN, f"learner.replay_priority={priority}")
    horizon = pair.tenv.num_steps
    jstep = jax.jit(pair.jagent.step)
    jts, tts = pair.jts, pair.tts
    for _ in range(2):
        draws = dqn_draws(jts, ref.STEPS, per=priority == "per",
                          horizon=horizon)
        jts, jm = jstep(jts)
        tts, tm = pair.tagent.step(tts, draws=draws)
        _assert_same_dqn_state(convert.train_state_to_numpy(tts), jts)
        assert set(tm) == set(jm)
        for key in jm:
            _close(float(tm[key]), float(jm[key]), err_msg=key)
    # The buffer wrapped and the target network synced.
    assert int(jm["replay_size"]) == 64 and int(jts.extras.replay.pos) != 0
    assert int(jts.updates) >= 5


def test_dqn_state_round_trips_a_checkpoint_and_converts(tmp_path):
    for priority in ("uniform", "per"):
        pair = ref._Pair("dqn", *DQN, f"learner.replay_priority={priority}")
        # The converted JAX init is the port's own init, extras included.
        want = pair.tagent.init(0)
        got = convert.train_state_to_numpy(pair.tts)
        assert set(got["extras"]) == set(
            convert.train_state_to_numpy(want)["extras"])
        ts, _ = pair.tagent.step(pair.tts)
        mgr = CheckpointManager(str(tmp_path / priority))
        mgr.save(int(ts.updates), ts, metadata={"episode": 0})
        restored, _ = mgr.restore(pair.tagent.init(1))
        a = convert.train_state_leaves(ts)
        b = convert.train_state_leaves(restored)
        assert set(a) == set(b)
        assert any(k.startswith("extras.replay.") for k in a)
        assert any(k.startswith("extras.per.tree.") for k in a) == \
            (priority == "per")
        for name in a:
            assert torch.equal(a[name], b[name]), name


def test_dqn_preempt_and_resume_ends_bit_equal(tmp_path):
    """The orchestrator on DQN (PER, so the sum-tree rides the checkpoint):
    preempted after chunk 1, resumed from ``tag_preempt``, the run ends on
    the state an uninterrupted run ends on, bit for bit, extras and
    generator included."""
    from sharetrade_tpu_torch.runtime import Orchestrator

    def run(name, hook=None, resume=False):
        cfg = FrameworkConfig().apply_overrides(
            ref._overrides("dqn", *DQN, "learner.replay_priority=per",
                           "runtime.checkpoint_every_updates=20",
                           f"runtime.checkpoint_dir={tmp_path / name}"))
        orch = Orchestrator(cfg, device="cpu",
                            fault_hook=None if hook is None
                            else lambda i, r: hook(orch, i))
        orch.send_training_data(ref._prices(ref.WINDOW + 40), resume=resume)
        orch.start_training(background=False)
        orch.stop()
        return orch

    whole = run("whole")
    first = run("cut", hook=lambda o, i: o.request_preempt() if i == 0
                else None)
    assert first.preempted and first.preempt_saved
    rest = run("cut", resume=True)
    assert rest.chunks == whole.chunks - 1 == 3
    a = convert.train_state_leaves(whole.train_state)
    b = convert.train_state_leaves(rest.train_state)
    assert set(a) == set(b) and any(k.startswith("extras.per.") for k in a)
    for name in a:
        assert torch.equal(a[name], b[name]), name


def test_fill_replay_from_arrays_matches_jax():
    """150 transitions into a 64-slot buffer in capacity-sized slices:
    the newest win, in the JAX buffer's slots; then a uniform sample reads
    valid slots only."""
    from sharetrade_tpu.agents import dqn as jdqn
    rng = np.random.default_rng(3)
    n, dim = 150, ref.OBS
    obs = rng.standard_normal((n, dim)).astype(np.float32)
    nxt = rng.standard_normal((n, dim)).astype(np.float32)
    act = rng.integers(0, 3, n).astype(np.int32)
    rew = rng.standard_normal(n).astype(np.float32)
    jbuf = jdqn.fill_replay_from_arrays(
        jdqn.ReplayBuffer.create(64, dim), obs, act, rew, nxt)
    tbuf = tdqn.fill_replay_from_arrays(
        tdqn.ReplayBuffer.create(64, dim), obs, act, rew, nxt)
    for name in ("obs", "action", "reward", "next_obs", "pos", "size"):
        np.testing.assert_array_equal(getattr(tbuf, name).numpy(),
                                      np.asarray(getattr(jbuf, name)),
                                      err_msg=name)
    small = tdqn.fill_replay_from_arrays(
        tdqn.ReplayBuffer.create(64, dim), obs[:5], act[:5], rew[:5], nxt[:5])
    b_obs, b_act, _, _ = small.sample(torch.tensor([0.0, 0.5, 0.999999]))
    np.testing.assert_array_equal(b_obs.numpy(), obs[[0, 2, 4]])
    assert b_act.tolist() == act[[0, 2, 4]].tolist()
