"""``cli train`` and the training orchestrator of the port, on the CPU.

A tiny episode transformer (window 12, head_dim 16, 4 agents, 16-step
chunks) trains PPO through ``python -m sharetrade_tpu_torch.cli train
--device cpu`` (rc 0 and the summary JSON line), through the
``Orchestrator`` in process (the episode gate, the re-arm between episodes,
GetAvg/GetStd in both their progressive and trained-only forms, the
stashed StartTraining), and under SIGTERM (exit 75 at a chunk boundary).
The run leaves its checkpoints and its price journal, which replays to
one ``prices_fetched`` event. The checkpoint chain: ``train --eval`` preempted by SIGTERM (exit 75,
``tag_preempt`` written), ``train --resume --eval`` (completes, keeps
``tag_best``), then ``serve`` from the same directory boots from
``tag_best`` (``params_step`` its update count); ``--resume`` with nothing
to resume from exits 1.
"""

import json
import os
import pathlib
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

from sharetrade_tpu_torch.config import ConfigError, FrameworkConfig
from sharetrade_tpu_torch.data.journal import Journal
from sharetrade_tpu_torch.runtime.lifecycle import Phase, ReplyState
from sharetrade_tpu_torch.runtime.orchestrator import Orchestrator

REPO = pathlib.Path(__file__).resolve().parents[1]

SMALL = ["learner.algo=ppo", "model.kind=transformer",
         "model.seq_mode=episode", "model.head_dim=16", "model.num_heads=2",
         "env.window=12", "parallel.num_workers=4", "runtime.chunk_steps=16",
         "learner.ppo_epochs=1", "learner.ppo_minibatches=2"]


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _cmd(*extra):
    cmd = [sys.executable, "-m", "sharetrade_tpu_torch.cli", "train",
           "--device", "cpu"]
    for item in SMALL + list(extra):
        cmd += ["--set", item]
    return cmd


def test_cli_train_on_cpu(tmp_path):
    out = subprocess.run(_cmd("data.synthetic_length=44"),
                         capture_output=True, text=True, timeout=180,
                         cwd=tmp_path, env=_env())
    assert out.returncode == 0, out.stderr[-2000:]
    summary = json.loads(out.stdout.strip().splitlines()[-1])
    assert set(summary) >= {"avg_portfolio", "std_portfolio", "env_steps",
                            "updates", "agent_steps_per_sec", "elapsed_s",
                            "restarts"}
    assert np.isfinite(summary["avg_portfolio"])
    assert summary["env_steps"] == 32 and summary["updates"] == 4
    assert summary["restarts"] == 0
    # On the CPU every kernel wrapper takes its plain version.
    assert set(summary["kernel_launches"].values()) == {0}
    assert "The average of the portfolios" in out.stderr
    # Nothing around it but the run's checkpoints (runtime.checkpoint_dir)
    # and its price journal (data.journal_dir), as the JAX cli train leaves.
    assert sorted(p.name for p in tmp_path.iterdir()) == ["checkpoints",
                                                          "journal"]
    with Journal(str(tmp_path / "journal" / "price-events.journal")) as j:
        assert [e["type"] for e in j.replay()] == ["prices_fetched"]


def test_cli_train_sigterm_exits_75(tmp_path):
    proc = subprocess.Popen(_cmd("data.synthetic_length=20000"),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, cwd=tmp_path, env=_env())
    try:
        deadline = time.monotonic() + 120
        for line in proc.stderr:
            if "loaded" in line or time.monotonic() > deadline:
                break
        time.sleep(1.0)
        proc.send_signal(signal.SIGTERM)
        _out, err = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 75, err[-2000:]


def _orchestrator(tmp_path, *extra):
    cfg = FrameworkConfig().apply_overrides(
        SMALL + [f"runtime.checkpoint_dir={tmp_path / 'ckpts'}"] + list(extra))
    return Orchestrator(cfg, device="cpu")


def _prices(length):
    rng = np.random.default_rng(0)
    return (50.0 * np.exp(np.cumsum(rng.uniform(-0.02, 0.02, length)))
            ).astype(np.float32)


def test_orchestrator_episodes_rearm_and_queries(tmp_path):
    orch = _orchestrator(tmp_path, "runtime.episodes=2")
    assert orch.get_avg().state is ReplyState.NO_TRAINING_DATA
    assert orch.is_everything_done().state is ReplyState.NO_TRAINING_DATA
    orch.start_training(background=False)          # stashed until data
    assert orch.lifecycle.phase is Phase.AWAITING_DATA
    orch.send_training_data(_prices(12 + 40))      # horizon 40: 3 chunks
    assert orch.lifecycle.phase is Phase.COMPLETED
    assert orch.is_everything_done().state is ReplyState.COMPLETED
    assert orch.episode == 2
    snap = orch.snapshot()
    # Episode 1 ends after 3 chunks at 40 env steps (the third chunk's last
    # 8 steps find every agent frozen at the horizon and do not count); the
    # re-armed episode 2 ends at 80.
    assert snap["env_steps"] == 80 and snap["trained_workers"] == 4
    assert snap["updates"] == 6 * 2
    avg = orch.get_avg(trained_only=False)
    assert avg.ok and avg.value == snap["portfolio_mean"]
    trained = orch.get_std(trained_only=True)
    assert trained.ok and trained.value == snap["portfolio_std_trained"]
    assert int(orch.train_state.env_state.t.max()) == 40


def test_preempt_mid_episode_and_trained_only_not_computed(tmp_path):
    orch = _orchestrator(tmp_path)
    orch.send_training_data(_prices(12 + 4000))
    orch.start_training(background=True)
    deadline = time.monotonic() + 120
    while orch.chunks < 1 and time.monotonic() < deadline:
        time.sleep(0.05)
    orch.request_preempt()
    assert orch.wait(timeout=120)
    assert orch.preempted and orch.lifecycle.phase is Phase.TRAINING
    assert orch.is_everything_done().state \
        is ReplyState.TRAINING_NOT_COMPLETED
    assert orch.get_avg(trained_only=False).ok
    assert orch.get_avg(trained_only=True).state is ReplyState.NOT_COMPUTED


@pytest.mark.parametrize("knob", ["runtime.profile_dir=trace",
                                  "obs.enabled=true",
                                  "learner.remat=true",
                                  "model.remat_blocks=true",
                                  "model.moe_experts=4"])
def test_unported_knobs_are_refused(knob, tmp_path):
    with pytest.raises(ConfigError, match="not yet ported"):
        orch = _orchestrator(tmp_path, knob)
        orch.send_training_data(_prices(60))


@pytest.mark.parametrize("knob", ["runtime.megachunk_factor=2",
                                  "runtime.pipeline_depth=3"])
def test_megachunk_and_pipeline_knobs_are_accepted(knob, tmp_path):
    orch = _orchestrator(tmp_path, knob, "runtime.async_pipeline=true")
    orch.send_training_data(_prices(12 + 64))
    orch.start_training(background=False)
    assert orch.lifecycle.phase is Phase.COMPLETED
    assert orch.snapshot()["env_steps"] == 64
    assert orch.pipeline_stats["boundaries"] >= 1


def _serve_cmd(*extra):
    cmd = [sys.executable, "-m", "sharetrade_tpu_torch.cli", "serve",
           "--device", "cpu", "--duration", "1", "--sessions", "8"]
    for item in SMALL + ["serve.max_batch=4", "serve.slots=8"] + list(extra):
        cmd += ["--set", item]
    return cmd


def test_cli_train_preempt_resume_then_serve_from_tag_best(tmp_path):
    env = _env()
    # Nothing to resume from yet: the JAX package's message, exit 1.
    out = subprocess.run(_cmd("data.synthetic_length=44") + ["--resume"],
                         capture_output=True, text=True, timeout=180,
                         cwd=tmp_path, env=env)
    assert out.returncode == 1 and "--resume:" in out.stderr

    # A run of many 2-chunk episodes, preempted once the first re-arms.
    proc = subprocess.Popen(
        _cmd("data.synthetic_length=44", "runtime.episodes=100000")
        + ["--eval"], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, cwd=tmp_path, env=env)
    try:
        deadline = time.monotonic() + 120
        for line in proc.stderr:
            if "re-arming" in line or time.monotonic() > deadline:
                break
        proc.send_signal(signal.SIGTERM)
        _out, err = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 75, err[-2000:]
    assert "emergency checkpoint: written" in err
    ckpts = tmp_path / "checkpoints"
    preempt = json.loads((ckpts / "tag_preempt" / "meta.json").read_text())
    assert preempt["preempted"] and preempt["updates"] >= 4

    out = subprocess.run(
        _cmd("data.synthetic_length=44", "runtime.episodes=1")
        + ["--resume", "--eval", "--eval-best"], capture_output=True,
        text=True, timeout=180, cwd=tmp_path, env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    summary = json.loads(out.stdout.strip().splitlines()[-1])
    assert summary["restarts"] == 0
    assert summary["updates"] > preempt["updates"]
    assert np.isfinite(summary["eval_portfolio"])
    assert np.isfinite(summary["eval_reward_sum"])
    assert summary["best_eval_updates"] == summary["updates"]
    best = json.loads((ckpts / "tag_best" / "meta.json").read_text())
    assert best["updates"] == summary["updates"]

    out = subprocess.run(_serve_cmd(), capture_output=True, text=True,
                         timeout=180, cwd=tmp_path, env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = [json.loads(ln) for ln in out.stdout.splitlines()
             if ln.startswith("{")]
    assert lines[0]["event"] == "serving_ready"
    assert lines[0]["params_step"] == best["updates"] > 0
    assert lines[-1]["params_step"] == best["updates"]
    assert lines[-1]["completed"] > 0 and lines[-1]["failed"] == 0
