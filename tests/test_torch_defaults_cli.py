"""``cli train`` and ``cli serve`` of the port at the JAX package's defaults
(the reference workload: the Q-network, Q-learning), on the CPU.

Only the sizes are set (``--device cpu``, a 316-tick series, window 16,
hidden 16, 50-step chunks); the learner, the model and everything else are
the defaults. ``train`` prints the JAX ``cli train`` line's keys for each
learner (``qlearn``, ``dqn`` uniform and PER, ``pg``, ``a2c``) and, with
``--eval``, the greedy eval; ``serve`` then boots the Q-network from that
run's ``tag_best`` with the weight-swap watcher running
(``serve.swap_poll_s`` defaults to 5 s). ``serve`` refuses, with a
``ConfigError`` and exit code 2, the knobs it cannot honour yet and a
missing tuned profile, and runs the online controller.
"""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
SIZES = ["data.synthetic_length=316", "env.window=16", "model.hidden_dim=16",
         "runtime.chunk_steps=50"]
KEYS = {"avg_portfolio", "std_portfolio", "env_steps", "updates",
        "agent_steps_per_sec", "elapsed_s", "restarts"}


def _run(command, cwd, *extra, args=()):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    cmd = [sys.executable, "-m", "sharetrade_tpu_torch.cli", command,
           "--device", "cpu", *args]
    for item in SIZES + list(extra):
        cmd += ["--set", item]
    return subprocess.run(cmd, capture_output=True, text=True, timeout=240,
                          cwd=cwd, env=env)


@pytest.mark.parametrize("extra", [
    [], ["learner.algo=dqn", "learner.replay_batch=32"],
    ["learner.algo=dqn", "learner.replay_batch=32",
     "learner.replay_priority=per"],
    ["learner.algo=pg"], ["learner.algo=a2c"]],
    ids=["qlearn", "dqn", "dqn_per", "pg", "a2c"])
def test_cli_train_at_the_defaults(extra, tmp_path):
    out = _run("train", tmp_path, *extra)
    assert out.returncode == 0, out.stderr[-2000:]
    summary = json.loads(out.stdout.strip().splitlines()[-1])
    assert set(summary) >= KEYS
    assert np.isfinite(summary["avg_portfolio"])
    assert summary["env_steps"] == 300 and summary["restarts"] == 0
    assert "The average of the portfolios" in out.stderr


def test_cli_train_eval_then_serve_from_tag_best(tmp_path):
    train = _run("train", tmp_path, args=["--eval"])
    assert train.returncode == 0, train.stderr[-2000:]
    summary = json.loads(train.stdout.strip().splitlines()[-1])
    assert np.isfinite(summary["eval_portfolio"])
    best = json.loads((tmp_path / "checkpoints" / "tag_best" /
                       "meta.json").read_text())
    serve = _run("serve", tmp_path, "serve.max_batch=4", "serve.slots=8",
                 args=["--duration", "1", "--sessions", "12"])
    assert serve.returncode == 0, serve.stderr[-2000:]
    lines = [json.loads(ln) for ln in serve.stdout.splitlines()
             if ln.startswith("{")]
    assert lines[0]["event"] == "serving_ready"
    assert lines[0]["model"] == "q_mlp"
    assert lines[0]["params_step"] == best["updates"] == summary["updates"]
    assert lines[-1]["completed"] > 0 and lines[-1]["failed"] == 0
    assert lines[-1]["generic_batches"] > 0
    # The weight-swap watcher runs at the default poll, and nothing is
    # served without a word.
    assert lines[0]["swap_watcher"] is True
    assert lines[-1]["swap_rejected"] == 0
    assert lines[-1]["params_step"] == best["updates"]
    assert "not yet ported" not in serve.stderr


def test_cli_serve_builds_the_head_the_learner_trains(tmp_path):
    serve = _run("serve", tmp_path, "learner.algo=a2c", "serve.max_batch=4",
                 "serve.slots=8", args=["--duration", "0.5",
                                        "--sessions", "8"])
    assert serve.returncode == 0, serve.stderr[-2000:]
    assert json.loads(serve.stdout.splitlines()[0])["model"] == "ac_mlp"
    off = _run("serve", tmp_path, "serve.swap_poll_s=0", "serve.max_batch=4",
               "serve.slots=8", args=["--duration", "0.5", "--sessions", "8"])
    assert off.returncode == 0 and "swap_poll_s" not in off.stderr
    assert json.loads(off.stdout.splitlines()[0])["swap_watcher"] is False


@pytest.mark.parametrize("knob", [
    "obs.enabled=true", "tuning.profile=/nonexistent/tuned_profile.json"])
def test_cli_serve_refuses_what_it_cannot_honour(knob, tmp_path):
    """``obs.enabled`` is not ported; a profile that is not there is a
    ``ProfileError`` (a ``ConfigError``), as in the JAX package."""
    serve = _run("serve", tmp_path, knob, args=["--duration", "0.5"])
    assert serve.returncode == 2
    if knob.startswith("obs."):
        assert ("ConfigError" in serve.stderr
                and "not yet ported" in serve.stderr)
    else:
        assert ("ProfileError" in serve.stderr
                and "tuned profile not found" in serve.stderr)
    assert not serve.stdout.strip()


def test_cli_serve_runs_the_online_controller(tmp_path):
    """``tuning.serve_controller`` serves: a target no tick can meet makes
    the controller tighten, and the summary counts its adjustments."""
    serve = _run("serve", tmp_path, "tuning.serve_controller=true",
                 "tuning.target_p99_ms=0.001",
                 "tuning.controller_interval_s=0.1", "serve.max_batch=4",
                 "serve.slots=8", args=["--duration", "1", "--sessions", "8"])
    assert serve.returncode == 0, serve.stderr[-2000:]
    summary = json.loads(serve.stdout.strip().splitlines()[-1])
    assert summary["completed"] > 0 and summary["failed"] == 0
    assert summary["controller_adjustments"] > 0
    assert set(summary["stage_p99_ms"]) == {"queue_wait", "batch_wait",
                                            "device", "readback"}
    assert "serve controller tighten" in serve.stderr
