"""``python -m sharetrade_tpu_torch.cli serve`` end to end on the CPU.

The episode transformer (the model ``learner.algo=ppo`` trains) at a small
width (window 16, head_dim 16, 4-row batches over 8 slots, 12 sessions)
serves synthetic closed-loop load for one second: a ``serving_ready`` line, then a summary with completed
requests and no failures; the run leaves only its price journal.
"""

import json
import os
import pathlib
import signal
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]

ARGS = ["serve", "--device", "cpu", "--set", "learner.algo=ppo",
        "--set", "model.kind=transformer", "--set", "model.seq_mode=episode",
        "--set", "env.window=16", "--set", "model.head_dim=16",
        "--set", "data.synthetic_length=300",
        "--set", "serve.max_batch=4", "--set", "serve.slots=8",
        "--duration", "1", "--sessions", "12"]


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _run(args, tmp_path):
    return subprocess.run(
        [sys.executable, "-m", "sharetrade_tpu_torch.cli", *args],
        capture_output=True, text=True, timeout=180, cwd=tmp_path,
        env=_env())


def test_cli_serve_on_cpu(tmp_path):
    out = _run(ARGS, tmp_path)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = [json.loads(ln) for ln in out.stdout.splitlines()
             if ln.startswith("{")]
    assert lines[0]["event"] == "serving_ready"
    assert lines[0]["device"] == "cpu"
    summary = lines[-1]
    assert summary["completed"] > 0 and summary["failed"] == 0
    assert summary["prefills"] > 0 and summary["warm_rows"] > 0
    assert summary["drained"] and summary["stopped_clean"]
    # On the CPU the kernel wrapper takes its plain version: no launches.
    assert summary["flash_fwd_launches"] == 0
    # Writes nothing around it but its price journal (data.journal_dir),
    # as the JAX cli serve leaves it: one fetch event, lock released.
    assert [p.name for p in tmp_path.iterdir()] == ["journal"]
    from sharetrade_tpu_torch.data.journal import Journal
    with Journal(str(tmp_path / "journal" / "price-events.journal")) as j:
        assert [e["type"] for e in j.replay()] == ["prices_fetched"]


def test_cli_serve_params_from_npz(tmp_path):
    """``--params`` serves weights written from a params tree."""
    import torch

    from sharetrade_tpu_torch.convert import save_npz
    from sharetrade_tpu_torch.models.transformer_episode import (
        episode_transformer_policy)
    model = episode_transformer_policy(18, 3, num_layers=2, num_heads=4,
                                       head_dim=16, device="cpu")
    params_dir = tmp_path / "weights"
    params_dir.mkdir()
    save_npz(str(params_dir / "p.npz"),
             model.init(torch.Generator().manual_seed(3)))
    run_dir = tmp_path / "run"
    run_dir.mkdir()
    out = _run(ARGS + ["--params", str(params_dir / "p.npz")], run_dir)
    assert out.returncode == 0, out.stderr[-2000:]
    summary = json.loads(out.stdout.strip().splitlines()[-1])
    assert summary["completed"] > 0 and summary["failed"] == 0


def test_cli_rejects_unported_model(tmp_path):
    out = _run(["serve", "--device", "cpu", "--duration", "1",
                "--set", "learner.algo=ppo", "--set", "model.kind=transformer",
                "--set", "model.seq_mode=episode",
                "--set", "model.moe_experts=4"],
               tmp_path)
    assert out.returncode != 0
    assert "not yet ported" in out.stderr


def test_sigterm_drains_and_exits_75(tmp_path):
    proc = subprocess.Popen(
        [sys.executable, "-m", "sharetrade_tpu_torch.cli", *ARGS,
         "--duration", "60"],                 # the last --duration wins
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
        cwd=tmp_path, env=_env())
    try:
        ready = json.loads(proc.stdout.readline())
        assert ready["event"] == "serving_ready"
        proc.send_signal(signal.SIGTERM)
        rest, _ = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(10)
    assert proc.returncode == 75
    summary = json.loads(rest.strip().splitlines()[-1])
    assert summary["preempted"] and summary["drained"]
    assert summary["failed"] == 0 and summary["stopped_clean"]
