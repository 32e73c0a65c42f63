"""``tools/torch_autotune.py`` on the CPU: a ``--quick --device cpu`` serve
sweep at a tiny size writes a profile that the port's ``cli serve`` loads
(its serve knobs applied, the controller running beside them), the halving
ladder keeps the best arm, and without a GPU the tool refuses to run
unless it is given ``--device cpu``."""

import json
import os
import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "tools"))

import torch_autotune  # noqa: E402

from sharetrade_tpu_torch import tuning  # noqa: E402


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    return env


def test_successive_halving_keeps_the_best_arm():
    arms = [{"serve.max_batch": b} for b in (8, 16, 32, 64, 4)]
    seen = []

    def measure(arm, window):
        seen.append((arm["serve.max_batch"], window))
        return {"objective": -abs(arm["serve.max_batch"] - 30) + window,
                "elapsed_s": window}

    out = torch_autotune.successive_halving(arms, measure, rung0_window=1.0,
                                            eta=2, max_rungs=4)
    assert out["best"] == {"serve.max_batch": 32}
    assert seen[:5] == [(8, 1.0), (16, 1.0), (32, 1.0), (64, 1.0), (4, 1.0)]
    assert (32, 2.0) in seen and out["rungs"] >= 2


def test_quick_cpu_serve_sweep_profile_loads_in_cli_serve(tmp_path):
    profile = tmp_path / "tuned_profile.json"
    sweep = subprocess.run(
        [sys.executable, str(REPO / "tools" / "torch_autotune.py"),
         "--quick", "--spec", "serve", "--device", "cpu", "--json",
         "--out", str(profile)],
        capture_output=True, text=True, timeout=240, cwd=tmp_path,
        env=_env())
    assert sweep.returncode == 0, sweep.stderr[-2000:]
    summary = json.loads(sweep.stdout.strip().splitlines()[-1])
    knobs = tuning.load_profile(str(profile))["knobs"]
    assert set(knobs) == {"serve.max_batch", "serve.batch_timeout_ms",
                          "serve.max_queue"}
    assert knobs == summary["knobs"]
    assert summary["fingerprint"]["backend"] == "cpu"
    assert summary["specs"]["serve"]["arms"] == 4
    assert [p.name for p in tmp_path.iterdir()] == ["tuned_profile.json"]

    serve = subprocess.run(
        [sys.executable, "-m", "sharetrade_tpu_torch.cli", "serve",
         "--device", "cpu", "--duration", "0.5", "--sessions", "8",
         "--set", "data.synthetic_length=316", "--set", "env.window=16",
         "--set", "model.hidden_dim=16", "--set", f"tuning.profile={profile}",
         "--set", "tuning.serve_controller=true"],
        capture_output=True, text=True, timeout=240, cwd=tmp_path,
        env=_env())
    assert serve.returncode == 0, serve.stderr[-2000:]
    lines = [json.loads(ln) for ln in serve.stdout.splitlines()
             if ln.startswith("{")]
    assert lines[0]["max_batch"] == knobs["serve.max_batch"]
    assert lines[-1]["completed"] > 0 and lines[-1]["failed"] == 0
    assert "controller_adjustments" in lines[-1]
    assert "tuned profile" in serve.stderr


def test_no_gpu_without_device_cpu_exits_2(tmp_path, monkeypatch, capsys):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "p.json"
    assert torch_autotune.main(["--quick", "--spec", "serve",
                                "--out", str(out)]) == 2
    err = capsys.readouterr().err
    assert "CUDA" in err and "--device cpu" in err
    assert not out.exists()
