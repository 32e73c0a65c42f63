"""``cli train`` and the training orchestrator of the port, on the CPU.

A tiny episode transformer (window 12, head_dim 16, 4 agents, 16-step
chunks) trains PPO through ``python -m sharetrade_tpu_torch.cli train
--device cpu`` (rc 0 and the summary JSON line), through the
``Orchestrator`` in process (the episode gate, the re-arm between episodes,
GetAvg/GetStd in both their progressive and trained-only forms, the
stashed StartTraining), and under SIGTERM (exit 75 at a chunk boundary).
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
    assert list(tmp_path.iterdir()) == []     # writes nothing around it


def test_cli_train_sigterm_exits_75(tmp_path):
    proc = subprocess.Popen(_cmd("data.synthetic_length=20000"),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, cwd=tmp_path, env=_env())
    try:
        deadline = time.monotonic() + 120
        for line in proc.stderr:
            if "not yet ported" in line or time.monotonic() > deadline:
                break
        time.sleep(1.0)
        proc.send_signal(signal.SIGTERM)
        _out, err = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 75, err[-2000:]


def _orchestrator(*extra):
    cfg = FrameworkConfig().apply_overrides(SMALL + list(extra))
    return Orchestrator(cfg, device="cpu")


def _prices(length):
    rng = np.random.default_rng(0)
    return (50.0 * np.exp(np.cumsum(rng.uniform(-0.02, 0.02, length)))
            ).astype(np.float32)


def test_orchestrator_episodes_rearm_and_queries():
    orch = _orchestrator("runtime.episodes=2")
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


def test_preempt_mid_episode_and_trained_only_not_computed():
    orch = _orchestrator()
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


@pytest.mark.parametrize("knob", ["runtime.megachunk_factor=2",
                                  "runtime.eval_every_updates=5",
                                  "learner.remat=true",
                                  "model.remat_blocks=true",
                                  "learner.algo=dqn"])
def test_unported_knobs_are_refused(knob):
    with pytest.raises(ConfigError, match="not yet ported"):
        orch = _orchestrator(knob)
        orch.send_training_data(_prices(60))
