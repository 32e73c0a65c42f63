"""The port's checkpoint manager on the CPU, mirroring tests/test_checkpoint.py,
and held against the JAX package's.

- Save and restore: a bit-exact round trip (the generator's state and the
  bf16 carry included, the latter as its bits), at the flagship's widths;
  a run trained straight equals one trained, checkpointed, restored and
  trained on; retention, the torn write that stays invisible, the async
  save, metadata, fsync off.
- Integrity: checksums in meta; every corruption of the matrix is found,
  quarantined and walked past; non-finite params; all corrupt; an explicit
  corrupt step; a corrupt tag; a failed tag overwrite; a template or
  precision mismatch that raises without quarantining; a checkpoint
  without checksums; a params-only restore.
- Crashed writers: a complete tmp dir is published, a dead pid's debris
  swept, a live pid's dir left alone.
- Against the JAX package: a JAX checkpoint of the small episode-PPO state,
  read with flax, converted and saved by the port's manager, restores in
  the port, and one PPO step on it (the JAX draws handed in) matches the
  JAX step from the same checkpoint within tests/test_torch_ppo.py's fp32
  tolerances; the port's meta.json has every key of the JAX package's.
- ``convert.save_train_state_npz``: generator and bf16 bits kept; a file of
  the older form (float32 carry, no generator) still loads.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from sharetrade_tpu_torch import convert
from sharetrade_tpu_torch.agents import build_agent
from sharetrade_tpu_torch.checkpoint import (
    CheckpointCorruptError, CheckpointIntegrityError, CheckpointManager,
    verify_checkpoint_files)
from sharetrade_tpu_torch.config import FrameworkConfig
from sharetrade_tpu_torch.env.trading import make_trading_env

WINDOW = 12
SMALL = ["learner.algo=ppo", "model.kind=transformer",
         "model.seq_mode=episode", "model.head_dim=16", "model.num_heads=2",
         f"env.window={WINDOW}", "parallel.num_workers=4",
         "runtime.chunk_steps=8", "learner.ppo_epochs=1",
         "learner.ppo_minibatches=2", "precision.mode=bf16_mixed"]


def _prices(n=WINDOW + 48):
    rng = np.random.default_rng(0)
    return (50.0 * np.exp(np.cumsum(rng.uniform(-0.02, 0.02, n)))
            ).astype(np.float32)


def make_agent(*extra):
    cfg = FrameworkConfig().apply_overrides(SMALL + list(extra))
    env = make_trading_env(_prices(), window=cfg.env.window, device="cpu")
    return build_agent(cfg, env, device="cpu")


def _bits(x):
    return x.view(torch.int16) if x.dtype == torch.bfloat16 else x


def assert_same_state(a, b):
    """Every leaf equal bit for bit, the generator's state included."""
    la, lb = convert.train_state_leaves(a), convert.train_state_leaves(b)
    assert set(la) == set(lb)
    for name in la:
        assert la[name].dtype == lb[name].dtype, name
        assert torch.equal(_bits(la[name]), _bits(lb[name])), name


@pytest.fixture(scope="module")
def agent():
    return make_agent()


@pytest.fixture(scope="module")
def states(agent):
    """A fresh state and the states after 1, 2 and 3 chunks (copies: the
    step updates params and moments in place)."""
    from sharetrade_tpu_torch.runtime.orchestrator import _clone_state
    ts = agent.init(0)
    out = [_clone_state(ts)]
    for _ in range(3):
        ts, _ = agent.step(ts)
        out.append(_clone_state(ts))
    return out


class TestSaveRestore:
    def test_round_trip_bit_exact(self, tmp_path, agent, states):
        ts = states[1]
        assert ts.carry["k"].dtype == torch.bfloat16
        mgr = CheckpointManager(str(tmp_path), keep=3)
        mgr.save(int(ts.updates), ts)
        restored, step = mgr.restore(agent.init(99))   # different init
        assert step == int(ts.updates)
        assert_same_state(ts, restored)
        # The bf16 carry is stored as its bits, its dtype in meta.json.
        meta = mgr.metadata(step)
        assert meta["dtypes"]["carry.k"] == "bfloat16"
        with np.load(tmp_path / f"ckpt_{step:010d}" / "state.npz",
                     allow_pickle=False) as data:
            assert data["carry.k"].dtype == np.uint16
            assert data["rng"].dtype == np.uint8

    def test_resume_continues_identically(self, tmp_path, agent, states):
        """Training straight == training, checkpoint, restore, training on:
        params, moments, generator, cursors and carry all round-trip."""
        from sharetrade_tpu_torch.runtime.orchestrator import _clone_state
        straight = states[3]
        mgr = CheckpointManager(str(tmp_path))
        mgr.save(1, states[1])
        restored, _ = mgr.restore(agent.init(1))
        for _ in range(2):
            restored, _ = agent.step(restored)
        assert_same_state(straight, _clone_state(restored))

    def test_flagship_shaped_round_trip(self, tmp_path):
        """The flagship's widths (L 2, H 2, Dh 128, window 201, bf16_mixed,
        adagrad; 8 agents instead of 512): bit for bit, generator and the
        bf16 K/V carry included."""
        prices = _prices(201 + 40)
        cfg = FrameworkConfig().apply_overrides([
            "learner.algo=ppo", "model.kind=transformer",
            "model.seq_mode=episode", "model.num_layers=2",
            "model.num_heads=2", "model.head_dim=128", "env.window=201",
            "precision.mode=bf16_mixed", "parallel.num_workers=8"])
        agent = build_agent(cfg, make_trading_env(prices, window=201,
                                                  device="cpu"),
                            device="cpu")
        ts = agent.init(5)
        gen = torch.Generator().manual_seed(1)
        ts = ts.replace(carry={
            **ts.carry,
            "k": torch.randn(ts.carry["k"].shape, generator=gen
                             ).to(torch.bfloat16),
            "v": torch.randn(ts.carry["v"].shape, generator=gen
                             ).to(torch.bfloat16)})
        torch.rand(3, generator=ts.rng)             # move the generator on
        mgr = CheckpointManager(str(tmp_path), precision_mode="bf16_mixed")
        mgr.save(7, ts)
        restored, _ = mgr.restore(agent.init(6))
        assert sum(p.numel() for p in convert.flatten(
            restored.params, leaf=lambda x: x).values()) == 1_583_108
        assert restored.carry["k"].shape == (8, 2, 2, 201, 128)
        assert_same_state(ts, restored)
        assert torch.equal(torch.rand(4, generator=ts.rng),
                           torch.rand(4, generator=restored.rng))

    def test_retention_prunes_oldest(self, tmp_path, states):
        mgr = CheckpointManager(str(tmp_path), keep=2)
        for step in [10, 20, 30, 40]:
            mgr.save(step, states[0])
        assert mgr.steps() == [30, 40]

    def test_restore_specific_step(self, tmp_path, agent, states):
        mgr = CheckpointManager(str(tmp_path), keep=5)
        mgr.save(10, states[0])
        mgr.save(20, states[1])
        restored, step = mgr.restore(agent.init(9), step=10)
        assert step == 10
        assert_same_state(states[0], restored)

    def test_torn_write_invisible(self, tmp_path, states):
        mgr = CheckpointManager(str(tmp_path))
        mgr.save(5, states[0])
        os.makedirs(tmp_path / "tmp-7-12345")
        (tmp_path / "tmp-7-12345" / "state.npz").write_bytes(b"partial")
        assert mgr.steps() == [5]
        assert mgr.latest_step() == 5

    def test_async_save_restores_identically(self, tmp_path, agent, states):
        ts = states[1]
        mgr = CheckpointManager(str(tmp_path))
        mgr.save_async(int(ts.updates), ts)
        assert mgr.wait_pending(timeout=30)
        restored, step = mgr.restore(agent.init(9))
        assert step == int(ts.updates)
        assert_same_state(ts, restored)
        stats = mgr.save_stats[-1]
        assert stats["step"] == step and stats["bytes"] > 0
        assert stats["loop_ms"] >= 0 and stats["writer_ms"] > 0

    def test_async_save_owns_its_copy(self, tmp_path, agent):
        """The next step updates params in place: the queued save must hold
        the bytes of the state it was handed."""
        ts = agent.init(3)
        mgr = CheckpointManager(str(tmp_path))
        want = convert.train_state_to_numpy(ts)["params"]["policy"]["w"]
        mgr.save_async(0, ts)
        agent.step(ts)
        mgr.wait_pending(timeout=30)
        restored, _ = mgr.restore(agent.init(9))
        assert np.array_equal(restored.params["policy"]["w"].numpy(), want)

    def test_metadata(self, tmp_path, states):
        mgr = CheckpointManager(str(tmp_path))
        mgr.save(7, states[0], metadata={"note": "mid-episode"})
        meta = mgr.metadata(7)
        assert meta["step"] == 7 and meta["note"] == "mid-episode"

    def test_fsync_off_still_round_trips(self, tmp_path, agent, states):
        mgr = CheckpointManager(str(tmp_path), fsync=False)
        mgr.save(3, states[2])
        restored, step = mgr.restore(agent.init(5))
        assert step == 3
        assert_same_state(states[2], restored)


# ---------------------------------------------------------------------------
# integrity
# ---------------------------------------------------------------------------

def _truncate(path, size):
    with open(path, "r+b") as f:
        f.truncate(size)


def _bitflip(path, frac=0.5):
    size = os.path.getsize(path)
    off = max(0, min(size - 1, int(size * frac)))
    with open(path, "r+b") as f:
        f.seek(off)
        b = f.read(1)
        f.seek(off)
        f.write(bytes([b[0] ^ 0xFF]))


def _state(d):
    return os.path.join(d, "state.npz")


CORRUPTIONS = [
    ("state_truncated_empty", lambda d: _truncate(_state(d), 0),
     "state_checksum"),
    ("state_truncated_1byte", lambda d: _truncate(_state(d), 1),
     "state_checksum"),
    ("state_truncated_half",
     lambda d: _truncate(_state(d), os.path.getsize(_state(d)) // 2),
     "state_checksum"),
    ("state_truncated_last_byte",
     lambda d: _truncate(_state(d), os.path.getsize(_state(d)) - 1),
     "state_checksum"),
    ("state_bitflipped", lambda d: _bitflip(_state(d)), "state_checksum"),
    ("state_missing", lambda d: os.remove(_state(d)), "state_missing"),
    ("meta_missing", lambda d: os.remove(os.path.join(d, "meta.json")),
     "meta_missing"),
    ("meta_garbled",
     lambda d: open(os.path.join(d, "meta.json"), "w").write("{nope"),
     "meta_garbled"),
    ("meta_bitflipped",
     lambda d: _bitflip(os.path.join(d, "meta.json"), 0.9), None),
    ("empty_dir",
     lambda d: [os.remove(os.path.join(d, n)) for n in os.listdir(d)],
     None),
]


class TestIntegrity:
    @staticmethod
    def _three(tmp_path, states, **kwargs):
        """Steps 10 < 20 < 30, each from a distinct train state."""
        mgr = CheckpointManager(str(tmp_path), keep=5, **kwargs)
        for step, ts in zip((10, 20, 30), states[1:]):
            mgr.save(step, ts)
        return mgr

    def test_meta_records_checksums(self, tmp_path, states):
        meta = self._three(tmp_path, states).metadata(30)
        integ = meta["integrity"]
        assert integ["algo"] == "sha256"
        assert len(integ["state.npz"]) == 64
        assert len(integ["meta_sha256"]) == 64

    def test_verify_accepts_intact(self, tmp_path, states):
        mgr = self._three(tmp_path, states)
        assert mgr.verify()["step"] == 30
        assert mgr.verify(10)["step"] == 10
        verify_checkpoint_files(str(tmp_path / "ckpt_0000000020"))
        assert mgr.any_intact()

    @pytest.mark.parametrize("name,mutate,reason", CORRUPTIONS,
                             ids=[c[0] for c in CORRUPTIONS])
    def test_corrupt_newest_quarantined_and_walked_back(
            self, tmp_path, agent, states, name, mutate, reason):
        mgr = self._three(tmp_path, states)
        mutate(str(tmp_path / "ckpt_0000000030"))
        with pytest.raises(CheckpointIntegrityError):
            mgr.verify(30)
        restored, step = mgr.restore(agent.init(9))
        assert step == 20, "walk-back must serve the next-oldest intact step"
        assert_same_state(states[2], restored)
        corrupt = [n for n in os.listdir(tmp_path)
                   if n.startswith("corrupt_0000000030")]
        assert len(corrupt) == 1
        if reason is not None:
            assert reason in corrupt[0]
        assert mgr.steps() == [10, 20]
        assert mgr.counters["ckpt_quarantined_total"] == 1
        assert mgr.counters["ckpt_restore_fallbacks_total"] == 1
        assert mgr.last_restore_report["step"] == 20
        assert mgr.last_restore_report["skipped"][0][0] == 30

    def test_nonfinite_params_rejected(self, tmp_path, agent, states):
        mgr = self._three(tmp_path, states)
        ts = agent.init(0)
        poisoned = ts.replace(params={k: {n: torch.full_like(p, float("nan"))
                                          for n, p in v.items()}
                                      if isinstance(v, dict) else v
                                      for k, v in ts.params.items()})
        mgr.save(40, poisoned)
        _, step = mgr.restore(agent.init(9))
        assert step == 30
        assert any(n.startswith("corrupt_0000000040_nonfinite")
                   for n in os.listdir(tmp_path))

    def test_all_corrupt_raises_corrupt_error(self, tmp_path, agent, states):
        mgr = self._three(tmp_path, states)
        for step in (10, 20, 30):
            _bitflip(str(tmp_path / f"ckpt_{step:010d}" / "state.npz"))
        with pytest.raises(FileNotFoundError) as info:
            mgr.restore(agent.init(9))
        assert isinstance(info.value, CheckpointCorruptError)
        assert len([n for n in os.listdir(tmp_path)
                    if n.startswith("corrupt_")]) == 3

    def test_explicit_corrupt_step_raises_not_substitutes(self, tmp_path,
                                                          agent, states):
        mgr = self._three(tmp_path, states)
        _bitflip(str(tmp_path / "ckpt_0000000030" / "state.npz"))
        with pytest.raises(CheckpointCorruptError):
            mgr.restore(agent.init(9), step=30)

    def test_corrupt_tagged_quarantined(self, tmp_path, agent, states):
        mgr = self._three(tmp_path, states)
        mgr.save_tagged("best", states[0], metadata={"eval_portfolio": 1.0})
        _bitflip(str(tmp_path / "tag_best" / "state.npz"))
        with pytest.raises(CheckpointCorruptError):
            mgr.restore_tagged(agent.init(9), "best")
        assert any(n.startswith("corrupt_tag_best")
                   for n in os.listdir(tmp_path))

    def test_tagged_overwrite_failure_leaves_live_tag(self, tmp_path, agent,
                                                      states, monkeypatch):
        mgr = self._three(tmp_path, states)
        mgr.save_tagged("best", states[0], metadata={"v": 1})

        def boom(*a, **k):
            raise OSError("disk full")

        monkeypatch.setattr(mgr, "_write_payload_tmp", boom)
        with pytest.raises(OSError):
            mgr.save_tagged("best", states[1], metadata={"v": 2})
        restored, meta = mgr.restore_tagged(agent.init(9), "best")
        assert meta["v"] == 1
        assert_same_state(states[0], restored)

    def test_template_mismatch_raises_without_quarantine(self, tmp_path,
                                                         states):
        """A checksum-intact checkpoint of another config (here 8 agents
        instead of 4) raises and renames nothing."""
        mgr = self._three(tmp_path, states)
        other = make_agent("parallel.num_workers=8")
        with pytest.raises(ValueError, match="checksum-intact"):
            mgr.restore(other.init(0))
        assert mgr.steps() == [10, 20, 30]
        assert not any(n.startswith("corrupt_")
                       for n in os.listdir(tmp_path))

    def test_precision_mismatch_refused(self, tmp_path, agent, states):
        self._three(tmp_path, states, precision_mode="bf16_mixed")
        mgr = CheckpointManager(str(tmp_path), precision_mode="fp32")
        with pytest.raises(ValueError, match="precision.mode"):
            mgr.restore(agent.init(0))
        assert mgr.steps() == [10, 20, 30]

    def test_pre_integrity_checkpoint_still_restores(self, tmp_path, agent,
                                                     states):
        mgr = self._three(tmp_path, states)
        meta_path = tmp_path / "ckpt_0000000030" / "meta.json"
        meta = json.loads(meta_path.read_text())
        del meta["integrity"]
        meta_path.write_text(json.dumps(meta))
        _, step = mgr.restore(agent.init(9))
        assert step == 30

    def test_params_only_restore(self, tmp_path, agent, states):
        """A bare params tree as the template (``cli serve``'s boot)
        restores the params alone."""
        mgr = self._three(tmp_path, states)
        params, step = mgr.restore(agent.model.init(
            torch.Generator().manual_seed(4)))
        assert step == 30
        want = convert.flatten(states[3].params, leaf=lambda x: x)
        got = convert.flatten(params, leaf=lambda x: x)
        assert set(got) == set(want)
        assert all(torch.equal(got[k], want[k]) for k in want)


class TestTmpSweep:
    def test_complete_tmp_recovered_not_swept(self, tmp_path, agent, states):
        mgr = CheckpointManager(str(tmp_path))
        mgr.save(5, states[1])
        shutil.copytree(tmp_path / "ckpt_0000000005",
                        tmp_path / "tmp-5-999999999")
        shutil.rmtree(tmp_path / "ckpt_0000000005")
        mgr2 = CheckpointManager(str(tmp_path))
        assert mgr2.steps() == [5]
        assert not (tmp_path / "tmp-5-999999999").exists()
        restored, step = mgr2.restore(agent.init(9))
        assert step == 5
        assert_same_state(states[1], restored)

    def test_dead_pid_tmp_swept_at_init(self, tmp_path, states):
        CheckpointManager(str(tmp_path)).save(5, states[0])
        dead = tmp_path / "tmp-7-999999999"
        dead.mkdir()
        (dead / "state.npz").write_bytes(b"partial")
        mgr = CheckpointManager(str(tmp_path))
        assert not dead.exists(), "dead-pid tmp debris must be swept"
        assert mgr.steps() == [5]

    def test_live_pid_tmp_untouched(self, tmp_path):
        live = tmp_path / f"tmp-9-{os.getpid()}"
        live.mkdir()
        (live / "state.npz").write_bytes(b"mid-write")
        CheckpointManager(str(tmp_path))
        assert live.exists()


# ---------------------------------------------------------------------------
# convert's training-state .npz
# ---------------------------------------------------------------------------

def test_train_state_npz_keeps_generator_and_bf16_bits(tmp_path, states):
    ts = states[2]
    path = str(tmp_path / "state.npz")
    convert.save_train_state_npz(path, ts)
    loaded = convert.load_train_state_npz(path)
    assert loaded.carry["k"].dtype == torch.bfloat16
    assert_same_state(ts, loaded)


def test_train_state_npz_of_the_older_form_still_loads(tmp_path, states):
    """Files written before bf16 bits and generators were kept: a float32
    carry and no ``rng``; the generator is seeded."""
    ts = states[1]
    arrays, _ = convert.encode_train_state(convert.train_state_leaves(ts))
    arrays.pop("rng")
    for key in ("carry.k", "carry.v"):
        arrays[key] = ts.carry[key.split(".")[1]].float().numpy()
    path = str(tmp_path / "old.npz")
    np.savez(path, **arrays)
    loaded = convert.load_train_state_npz(path, seed=11)
    assert loaded.carry["k"].dtype == torch.float32
    assert torch.equal(loaded.carry["k"].to(torch.bfloat16), ts.carry["k"])
    assert torch.equal(torch.rand(3, generator=loaded.rng),
                       torch.rand(3, generator=torch.Generator(
                           ).manual_seed(11)))


# ---------------------------------------------------------------------------
# held against the JAX package
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_checkpoint(tmp_path_factory):
    """A JAX checkpoint of the small episode-PPO state after one step, its
    restore (flax), the port's save and restore of it, and the next step
    of each package from there (the JAX draws handed to the port)."""
    jax = pytest.importorskip("jax")
    import test_torch_ppo as tp
    from sharetrade_tpu.checkpoint import CheckpointManager as JaxManager

    root = tmp_path_factory.mktemp("jax_ckpt")
    pair = tp._Pair("fp32")
    jstep = jax.jit(pair.jagent.step)
    jts, _ = jstep(pair.jts)
    meta = {"episode": 0, "env_steps": int(jts.env_steps)}
    jmgr = JaxManager(str(root / "jax"), precision_mode="fp32")
    jmgr.save(int(jts.updates), jts, metadata=meta)
    jrestored, step = jmgr.restore(pair.jagent.init(jax.random.PRNGKey(9)))
    converted = convert.train_state_from_jax(
        jax.tree.map(np.asarray, jrestored))
    pmgr = CheckpointManager(str(root / "port"), precision_mode="fp32")
    pmgr.save(step, converted, metadata=meta)
    ported, _ = pmgr.restore(pair.tagent.init(9))
    out = {"jax_meta": jmgr.metadata(step), "port_meta": pmgr.metadata(step),
           "converted": convert.train_state_to_numpy(converted),
           "ported": convert.train_state_to_numpy(ported)}
    draws = tp._draws(jrestored.rng)
    jnext, _ = jstep(jrestored)
    tnext, _ = pair.tagent.step(ported, draws=draws)   # updates in place
    out.update(jnext=jax.tree.map(np.asarray, jnext),
               tnext=convert.train_state_to_numpy(tnext))
    return out


def test_jax_checkpoint_resumes_in_port_and_matches_jax_step(jax_checkpoint):
    import jax
    c = jax_checkpoint
    for a, b in zip(jax.tree.leaves(c["converted"]),
                    jax.tree.leaves(c["ported"])):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    # One step from the same checkpoint: tests/test_torch_ppo.py's fp32
    # tolerances.
    jts, t = c["jnext"], c["tnext"]
    for field in ("t", "budget", "shares", "share_value"):
        np.testing.assert_array_equal(t["env_state"][field],
                                      getattr(jts.env_state, field))
    assert int(t["env_steps"]) == int(jts.env_steps)
    assert int(t["updates"]) == int(jts.updates)
    for got, want in zip(jax.tree.leaves(t["params"]),
                         jax.tree.leaves(jts.params)):
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    for got, want in zip(jax.tree.leaves(t["opt_state"][0].sum_of_squares),
                         jax.tree.leaves(jts.opt_state[0].sum_of_squares)):
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-3)
    for key in ("k", "v"):
        np.testing.assert_allclose(t["carry"][key], jts.carry[key],
                                   atol=1e-4, rtol=0)


def test_port_meta_has_every_jax_key(jax_checkpoint):
    jmeta, pmeta = jax_checkpoint["jax_meta"], jax_checkpoint["port_meta"]
    assert set(jmeta) <= set(pmeta)
    assert set(jmeta["integrity"]) - {"state.msgpack"} \
        <= set(pmeta["integrity"])
    for key in ("step", "episode", "env_steps", "precision_mode"):
        assert pmeta[key] == jmeta[key]


# ---------------------------------------------------------------------------
# the JAX package's checkpoints in the same directory
# ---------------------------------------------------------------------------

def test_jax_checkpoint_dirs_survive_the_port(tmp_path):
    """A directory the JAX manager wrote (``save(10)``, ``save_tagged
    ("best")``) is foreign to the port: ``any_intact``, ``restore``,
    ``restore_tagged`` and ``cli serve``'s boot pass it over or refuse it
    (``ForeignCheckpointError``, a ``ValueError``), rename nothing, and the
    JAX manager restores both afterwards."""
    import subprocess
    import sys

    jax = pytest.importorskip("jax")
    import test_torch_ppo as tp
    from sharetrade_tpu.checkpoint import CheckpointManager as JaxManager
    from sharetrade_tpu_torch.checkpoint import ForeignCheckpointError

    ckpts = tmp_path / "checkpoints"
    pair = tp._Pair("fp32")
    jmgr = JaxManager(str(ckpts), precision_mode="fp32")
    jmgr.save(10, pair.jts, metadata={"episode": 0})
    jmgr.save_tagged("best", pair.jts, metadata={"updates": 10,
                                                 "eval_portfolio": 1.0})
    names = sorted(os.listdir(ckpts))

    port = CheckpointManager(str(ckpts), precision_mode="fp32")
    template = pair.tagent.init(0)
    assert port.steps() == [] and port.latest_step() is None
    assert not port.any_intact()
    assert port.tagged_metadata("best") is None
    with pytest.raises(FileNotFoundError):
        port.restore(template)
    with pytest.raises(ForeignCheckpointError):
        port.restore(template, step=10)
    with pytest.raises(ForeignCheckpointError):
        port.restore_tagged(template, "best")
    with pytest.raises(ForeignCheckpointError):
        port.save_tagged("best", template)
    assert sorted(os.listdir(ckpts)) == names

    # cli serve at the same directory boots an untrained policy, loudly.
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))) + os.pathsep + env.get("PYTHONPATH", "")
    cmd = [sys.executable, "-m", "sharetrade_tpu_torch.cli", "serve",
           "--device", "cpu", "--duration", "0.5", "--sessions", "4"]
    for item in tp.OVERRIDES + ["serve.max_batch=2", "serve.slots=4",
                                f"runtime.checkpoint_dir={ckpts}"]:
        cmd += ["--set", item]
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=180,
                         env=env, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.splitlines()[0])["params_step"] == 0
    assert "UNTRAINED" in out.stderr and "JAX package" in out.stderr
    assert sorted(os.listdir(ckpts)) == names

    template_j = pair.jagent.init(jax.random.PRNGKey(1))
    _, step = jmgr.restore(template_j)
    _, meta = jmgr.restore_tagged(template_j, "best")
    assert step == 10 and meta["updates"] == 10


def test_jax_trained_mlp_state_converts_and_trains_on(tmp_path):
    """The reference workload's state: a JAX Q-learning state after one
    chunk converts, goes through the port's checkpoint (``state.npz``, its
    empty carry included) and trains on: the next chunk, with the JAX
    draws, matches the JAX package's within tests/test_torch_reference.py's
    tolerances."""
    jax = pytest.importorskip("jax")
    import test_torch_reference as ref

    pair = ref._Pair("qlearn")
    jstep = jax.jit(pair.jagent.step)
    jts, _ = jstep(pair.jts)
    converted = convert.train_state_from_jax(jax.tree.map(np.asarray, jts))
    assert converted.carry == {} and converted.extras is None
    mgr = CheckpointManager(str(tmp_path), precision_mode="fp32")
    mgr.save(int(jts.updates), converted, metadata={"episode": 0})
    restored, _ = mgr.restore(pair.tagent.init(4))
    _, draws = ref.qlearn_draws(jts.rng, ref.STEPS)
    jnext, jm = jstep(jts)
    tnext, tm = pair.tagent.step(restored, draws=draws)
    for a, b in zip(jax.tree.leaves(convert.params_to_numpy(tnext.params)),
                    jax.tree.leaves(jnext.params)):
        ref._close(a, b, 1e-5)
    for key in jm:
        ref._close(float(tm[key]), float(jm[key]), 1e-5, key)


@pytest.mark.parametrize("family", ["lstm", "portfolio"])
def test_jax_family_checkpoint_resumes_in_port(family, tmp_path):
    """A JAX-written PPO state of the LSTM (its ``(h, c)`` carry) and of the
    2-asset portfolio (its (B, A) env leaves), one chunk in: saved by the
    JAX manager, restored with flax, converted, saved and restored by the
    port's manager bit for bit, and the next chunk from it (the JAX draws
    handed in) matches the JAX chunk within
    tests/test_torch_families_ppo.py's tolerances."""
    jax = pytest.importorskip("jax")
    import test_torch_families_ppo as fam
    from sharetrade_tpu.checkpoint import CheckpointManager as JaxManager

    jagent, tagent, jts, _, actions = fam._pair(family)
    jstep = jax.jit(jagent.step)
    jts, _ = jstep(jts)
    jmgr = JaxManager(str(tmp_path / "jax"), precision_mode="fp32")
    jmgr.save(int(jts.updates), jts, metadata={"episode": 0})
    jrestored, step = jmgr.restore(jagent.init(jax.random.PRNGKey(9)))
    converted = convert.train_state_from_jax(
        jax.tree.map(np.asarray, jrestored))
    pmgr = CheckpointManager(str(tmp_path / "port"), precision_mode="fp32")
    pmgr.save(step, converted, metadata={"episode": 0})
    ported, _ = pmgr.restore(tagent.init(9))
    assert type(ported.carry) is type(converted.carry)
    want = convert.train_state_leaves(converted)
    got = convert.train_state_leaves(ported)
    assert sorted(k for k in got if k != "rng") == sorted(
        k for k in want if k != "rng")
    for k, leaf in want.items():
        if k != "rng":
            assert torch.equal(got[k], leaf), k
    draws = fam._ppo_draws(jrestored.rng, actions)
    jnext, jm = jstep(jrestored)
    tnext, tm = tagent.step(ported, draws=draws)
    fam._compare(jnext, jm, tnext, tm)
