"""Supervision of the port's orchestrator held against the JAX package's.

Decision parity on the stub seam: both packages build the same small
episode-PPO run (window 12, 4 agents, 16-step chunks, a 64-step horizon,
so one episode is 4 chunks) and replace its step with the same stub
(``step_override``: every cursor advances one chunk, one update per chunk,
a fixed metrics row), then run the same ``fault_hook`` scripts as
tests/test_runtime.py's TestSupervision, TestFailedPhaseProtocol and
TestCrashSafety: a fault that heals, an exhausted restart budget, STOP,
RESUME, a ValueError that restarts, a failed run's queries, preemption
before the start, the preemption checkpoint preferred on resume, and
``tag_preempt`` re-preferred past a corrupt newest step. Each script must
give the same ``restarts``, ``agent_heals``, final phase and sequence of
event kinds in both.

Also:
- heal parity: one state with one NaN row, converted, goes through both
  ``_heal_agents``; the spliced env state and carry are equal (reset and
  the carry copy are deterministic);
- on the CPU with the real PPO step: train, preempt, ``--resume``, finish
  (and, the same way, a supervised restart) equals an uninterrupted run bit
  for bit.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sharetrade_tpu.config import ConfigError as JaxConfigError
from sharetrade_tpu.config import FrameworkConfig as JaxConfig
from sharetrade_tpu.runtime import Orchestrator as JaxOrchestrator
from sharetrade_tpu.utils.logging import EventLog as JaxEventLog
from sharetrade_tpu_torch import convert
from sharetrade_tpu_torch.config import ConfigError, FrameworkConfig
from sharetrade_tpu_torch.runtime import Orchestrator, Phase, ReplyState
from sharetrade_tpu_torch.runtime.orchestrator import _clone_state
from sharetrade_tpu_torch.utils.logging import EventLog

WINDOW, CHUNK, HORIZON, WORKERS = 12, 16, 64, 4
SMALL = ["learner.algo=ppo", "model.kind=transformer",
         "model.seq_mode=episode", "model.head_dim=16", "model.num_heads=2",
         f"env.window={WINDOW}", f"parallel.num_workers={WORKERS}",
         f"runtime.chunk_steps={CHUNK}", "learner.ppo_epochs=1",
         "learner.ppo_minibatches=2", "runtime.metrics_every_chunks=1",
         "runtime.backoff_initial_s=0.01", "runtime.backoff_max_s=0.05",
         "runtime.max_restarts=3", "runtime.checkpoint_every_updates=2"]
PRICES = np.linspace(10.0, 20.0, WINDOW + HORIZON, dtype=np.float32)


def _stub(xp, full_like):
    """The stub step of one package: lockstep cursors advance one chunk
    (frozen at the horizon), one update per chunk."""
    def step(ts):
        t0 = int(np.asarray(ts.env_state.t)[0])
        t1 = min(t0 + CHUNK, HORIZON)
        ts = ts.replace(env_state=ts.env_state.replace(
            t=full_like(ts.env_state.t, t1)),
            env_steps=ts.env_steps + (t1 - t0), updates=ts.updates + 1)
        return ts, {"env_steps": float(np.asarray(ts.env_steps)),
                    "updates": float(np.asarray(ts.updates)), "loss": 0.5,
                    "portfolio_mean": 10.0, "portfolio_std": 0.0,
                    "trained_workers": float(WORKERS if t1 >= HORIZON else 0),
                    "unhealthy_workers": 0.0}
    return step


PACKAGES = {
    "jax": dict(cfg=JaxConfig, orch=JaxOrchestrator, events=JaxEventLog,
                config_error=JaxConfigError,
                stub=_stub(jnp, lambda x, v: jnp.full_like(x, v))),
    "torch": dict(cfg=FrameworkConfig,
                  orch=lambda cfg, **kw: Orchestrator(cfg, device="cpu", **kw),
                  events=EventLog, config_error=ConfigError,
                  stub=_stub(torch, lambda x, v: torch.full_like(x, v))),
}


def _run(pkg, tmp_path, script, *extra, fake_step=None, resume=False,
         before_start=None):
    """Run ``script`` (a function of the package's ConfigError returning a
    fault hook, or None) on the stub; returns the outcome to compare."""
    p = PACKAGES[pkg]
    cfg = p["cfg"]().apply_overrides(
        SMALL + [f"runtime.checkpoint_dir={tmp_path / pkg}"] + list(extra))
    path = tmp_path / f"{pkg}-events.jsonl"
    events = p["events"](str(path))
    orch = p["orch"](cfg, event_log=events,
                     step_override=fake_step or p["stub"],
                     fault_hook=script(p["config_error"]) if script else None)
    holder.append(orch)
    orch.send_training_data(PRICES, resume=resume)
    if before_start is not None:
        before_start(orch)
    orch.start_training(background=False)
    orch.stop()
    events.close()
    kinds = [json.loads(line)["kind"] for line in open(path)]
    return {"restarts": orch.restarts, "agent_heals": orch.agent_heals,
            "phase": orch.lifecycle.phase.value, "events": kinds,
            "preempted": orch.preempted,
            "updates": int(np.asarray(orch.train_state.updates)),
            "avg": orch.get_avg().state.value}


holder: list = []


def _fail_once_at(chunk, exc_type):
    def script(config_error):
        hits = []

        def hook(chunk_idx, row):
            if chunk_idx == chunk and not hits:
                hits.append(1)
                raise (config_error if exc_type is None
                       else exc_type)("injected")
        return hook
    return script


def _always(exc_type):
    def script(config_error):
        def hook(chunk_idx, row):
            raise (config_error if exc_type is None else exc_type)("always")
        return hook
    return script


SCRIPTS = {
    "fault_heals": _fail_once_at(1, RuntimeError),
    "budget_exhausted": _always(RuntimeError),
    "stop": _always(None),                     # the package's ConfigError
    "resume": _fail_once_at(0, ArithmeticError),
    "value_error_restarts": _fail_once_at(2, ValueError),
    "no_fault": None,
}


@pytest.mark.parametrize("name", list(SCRIPTS))
def test_decisions_match_jax(tmp_path, name):
    got = {pkg: _run(pkg, tmp_path, SCRIPTS[name]) for pkg in PACKAGES}
    assert got["torch"] == got["jax"]
    expect = {"fault_heals": (1, "completed"),
              "budget_exhausted": (4, "failed"), "stop": (0, "failed"),
              "resume": (0, "completed"), "value_error_restarts": (1,
                                                                  "completed"),
              "no_fault": (0, "completed")}[name]
    assert (got["torch"]["restarts"], got["torch"]["phase"]) == expect


def test_failed_run_serves_no_results_as_jax(tmp_path):
    """TestFailedPhaseProtocol: two chunks land a snapshot, then a
    ConfigError stops the run; neither package serves the snapshot."""
    def fake_step_for(pkg):
        calls = []

        def fake_step(ts):
            calls.append(1)
            return ts, {"env_steps": float(min(len(calls), 2)),
                        "updates": 0.0, "portfolio_mean": 10.0,
                        "portfolio_std": 0.0}
        return fake_step

    def script(config_error):
        def hook(chunk_idx, row):
            if chunk_idx >= 2:
                raise config_error("poisoned")
        return hook

    got = {}
    for pkg in PACKAGES:
        got[pkg] = _run(pkg, tmp_path, script, fake_step=fake_step_for(pkg))
        orch = holder[-1]
        assert orch.snapshot()["portfolio_mean"] == 10.0
        assert orch.get_std().state.value == "NotComputed"
        assert orch.is_everything_done().state.value == "NotComputed"
    assert got["torch"] == got["jax"]
    assert got["torch"]["phase"] == "failed"
    assert got["torch"]["avg"] == "NotComputed"


def test_preempt_before_start_as_jax(tmp_path):
    got = {pkg: _run(pkg, tmp_path, None, "runtime.episodes=200",
                     before_start=lambda o: o.request_preempt())
           for pkg in PACKAGES}
    assert got["torch"] == got["jax"]
    assert got["torch"]["preempted"] and got["torch"]["updates"] == 0
    assert holder[-1].checkpoints.tagged_metadata("preempt") is not None


def test_resume_prefers_preempt_checkpoint_as_jax(tmp_path):
    """A long run preempted after its fourth chunk writes tag_preempt; a
    new orchestrator resumes from it (not from the older cadence save)."""
    def script(config_error):
        def hook(chunk_idx, row):
            if chunk_idx == 4:
                holder[-1].request_preempt()
        return hook

    first = {pkg: _run(pkg, tmp_path, script, "runtime.episodes=200")
             for pkg in PACKAGES}
    assert first["torch"] == first["jax"]
    assert first["torch"]["preempted"] and first["torch"]["updates"] == 5
    resumed = {}
    for pkg in PACKAGES:
        resumed[pkg] = _run(pkg, tmp_path, None, "runtime.episodes=2",
                            resume=True)
    assert resumed["torch"] == resumed["jax"]
    assert "resumed_from_preempt" in resumed["torch"]["events"]
    assert resumed["torch"]["phase"] == "completed"


def test_resume_reprefers_preempt_past_corrupt_step_as_jax(tmp_path):
    """A corrupt newest step numbered above tag_preempt is quarantined by
    the walk-back, and the intact emergency checkpoint wins."""
    from test_checkpoint import _bitflip
    out = {}
    for pkg in PACKAGES:
        p = PACKAGES[pkg]
        cfg = p["cfg"]().apply_overrides(
            SMALL + [f"runtime.checkpoint_dir={tmp_path / pkg}"])
        orch = p["orch"](cfg, step_override=p["stub"])
        orch.send_training_data(PRICES)
        ts, mgr = orch.train_state, orch.checkpoints
        mgr.save(32, ts, metadata={"episode": 0, "env_steps": 32})
        mgr.save_tagged("preempt", ts, metadata={
            "updates": 47, "env_steps": 47, "episode": 0, "preempted": True})
        mgr.save(55, ts, metadata={"episode": 0, "env_steps": 55})
        payload = "state.msgpack" if pkg == "jax" else "state.npz"
        _bitflip(str(tmp_path / pkg / "ckpt_0000000055" / payload))
        template = (orch.agent.init(jax.random.PRNGKey(cfg.seed))
                    if pkg == "jax" else orch.agent.init(cfg.seed))
        _, step, meta = orch._restore_for_resume(template)
        out[pkg] = (step, meta["preempted"], sorted(
            x.name for x in (tmp_path / pkg).iterdir()
            if x.name.startswith("corrupt_")))
        orch.stop()
    assert out["torch"] == out["jax"]
    assert out["torch"][:2] == (47, True)
    assert out["torch"][2] == ["corrupt_0000000055_state_checksum"]


# ---------------------------------------------------------------------------
# heal parity
# ---------------------------------------------------------------------------

def test_heal_splices_the_same_row_as_jax(tmp_path):
    """One state with row 2's budget NaN and the cursors advanced: both
    packages respawn row 2 at the representative's cursor with its carry."""
    overrides = SMALL + [f"runtime.checkpoint_dir={tmp_path}"]
    jorch = JaxOrchestrator(JaxConfig().apply_overrides(overrides))
    jorch.send_training_data(PRICES)
    torch_orch = Orchestrator(FrameworkConfig().apply_overrides(overrides),
                              device="cpu")
    torch_orch.send_training_data(PRICES)

    rng = np.random.default_rng(7)
    jts = jorch.train_state
    budget = np.asarray(jts.env_state.budget).copy()
    budget[2] = np.nan
    carry = {k: rng.standard_normal(np.shape(v)).astype(np.asarray(v).dtype)
             if np.asarray(v).dtype.kind == "f" else np.asarray(v)
             for k, v in jts.carry.items()}
    jts = jts.replace(
        env_state=jts.env_state.replace(
            t=jnp.full_like(jts.env_state.t, 24),
            budget=jnp.asarray(budget),
            shares=jnp.asarray(rng.integers(0, 5, WORKERS), jnp.float32),
            share_value=jnp.asarray(rng.uniform(10, 20, WORKERS),
                                    jnp.float32)),
        carry={k: jnp.asarray(v) for k, v in carry.items()})
    jorch._ts = jts
    torch_orch._ts = convert.train_state_from_jax(
        jax.tree.map(np.asarray, jts))
    assert jorch._heal_agents() and torch_orch._heal_agents()
    assert jorch.agent_heals == torch_orch.agent_heals == 1
    jgot = jax.tree.map(np.asarray, jorch.train_state)
    tgot = convert.train_state_to_numpy(torch_orch.train_state)
    for field in ("t", "budget", "shares", "share_value"):
        np.testing.assert_array_equal(tgot["env_state"][field],
                                      getattr(jgot.env_state, field),
                                      err_msg=field)
    for key in jgot.carry:
        np.testing.assert_array_equal(tgot["carry"][key], jgot.carry[key],
                                      err_msg=key)
    assert tgot["env_state"]["t"][2] == 24
    assert np.isfinite(tgot["env_state"]["budget"]).all()
    np.testing.assert_array_equal(tgot["carry"]["k"][2],
                                  tgot["carry"]["k"][0])


# ---------------------------------------------------------------------------
# resume and restart on the CPU, the real PPO step
# ---------------------------------------------------------------------------

def _train(tmp_path, name, *, hook=None, resume=False):
    cfg = FrameworkConfig().apply_overrides(
        SMALL + [f"runtime.checkpoint_dir={tmp_path / name}",
                 "runtime.checkpoint_every_updates=4"])
    orch = Orchestrator(cfg, device="cpu", fault_hook=hook)
    holder.append(orch)
    orch.send_training_data(PRICES, resume=resume)
    orch.start_training(background=False)
    orch.stop()
    return orch


@pytest.mark.parametrize("interruption", ["preempt_resume", "restart"])
def test_interrupted_run_equals_uninterrupted_bitwise(tmp_path,
                                                      interruption):
    straight = _train(tmp_path, "straight")
    assert straight.lifecycle.phase is Phase.COMPLETED
    if interruption == "preempt_resume":
        first = _train(tmp_path, "cut", hook=lambda i, row: (
            holder[-1].request_preempt() if i == 1 else None))
        assert first.preempted and first.preempt_saved
        assert first.is_everything_done().state \
            is ReplyState.TRAINING_NOT_COMPLETED
        done = _train(tmp_path, "cut", resume=True)
    else:
        hits = []

        def hook(i, row):
            if i == 2 and not hits:
                hits.append(1)
                raise RuntimeError("injected")
        done = _train(tmp_path, "cut", hook=hook)
        assert done.restarts == 1
    assert done.lifecycle.phase is Phase.COMPLETED
    a = convert.train_state_leaves(_clone_state(straight.train_state))
    b = convert.train_state_leaves(_clone_state(done.train_state))
    assert set(a) == set(b)
    for name in a:
        assert torch.equal(a[name], b[name]), name
