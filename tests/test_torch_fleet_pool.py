"""The port's engine pool, ladder and autoscaler against the JAX package's,
and one real ``cli fleet`` on the CPU.

- ``EnginePool`` supervises stub workers (the JAX fleet test's stub, a
  stdlib HTTP server that prints the ``engine_listening`` line; no torch):
  ready and healthy, a SIGKILL respawned with the streak reset, a worker
  that keeps dying terminally failed while its sibling serves on, a
  bring-up that never listens killed at ``fleet.startup_timeout_s``, and an
  exit after ``quiesce`` retired rather than crashed.
- The ladder: the port pool's seeded backoff schedule equals the JAX
  pool's on the same config, and ``crash_step`` equals the JAX function on
  seeded streaks and policies.
- ``EngineAutoscaler.decide`` equals the JAX function on seeded history
  rows, and ``step`` (fake clock, stub pool) applies the same decisions.
- ``cli fleet --device cpu --engines 1`` at the default config (the
  reference q_mlp): ``fleet_ready`` with one engine, submits over the wire,
  SIGTERM drains and exits 75 with ``requests == completed``.
"""

from __future__ import annotations

import json
import os
import pathlib
import random
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

from sharetrade_tpu.config import FleetConfig as JFleetConfig
from sharetrade_tpu.config import FrameworkConfig as JFrameworkConfig
from sharetrade_tpu.distrib import ladder as jladder
from sharetrade_tpu.fleet import EnginePool as JEnginePool
from sharetrade_tpu.fleet.autoscale import EngineAutoscaler as JAutoscaler
from sharetrade_tpu_torch.config import FleetConfig, FrameworkConfig
from sharetrade_tpu_torch.distrib import ladder
from sharetrade_tpu_torch.fleet import EnginePool, FleetClient
from sharetrade_tpu_torch.fleet.autoscale import EngineAutoscaler
from sharetrade_tpu_torch.obs.tsdb import FLEET_HISTORY_FILE, TsdbRing

REPO = pathlib.Path(__file__).resolve().parents[1]

_HEALTHY_STUB = r"""
import json, sys
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
class H(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    def log_message(self, *a): pass
    def do_GET(self):
        body = json.dumps({"ok": True, "queue_depth": 1, "overload": 0,
                           "params_step": 3, "swaps_total": 0}).encode()
        self.send_response(200)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)
srv = ThreadingHTTPServer(("127.0.0.1", 0), H)
print(json.dumps({"event": "engine_listening", "host": "127.0.0.1",
                  "port": srv.server_address[1]}), flush=True)
srv.serve_forever()
"""


def _stub_spawn(script: str):
    def spawn(engine_id: str, log_path: str):
        with open(log_path, "ab") as log_f:
            return subprocess.Popen([sys.executable, "-c", script],
                                    stdout=log_f, stderr=subprocess.STDOUT)
    return spawn


def _fleet_cfg(tmp_path, cls=FrameworkConfig, **kw):
    cfg = cls()
    cfg.fleet.dir = str(tmp_path / "fleet")
    cfg.fleet.num_engines = kw.pop("num_engines", 2)
    cfg.fleet.engine_backoff_initial_s = 0.05
    cfg.fleet.engine_backoff_max_s = 0.2
    cfg.fleet.startup_timeout_s = kw.pop("startup_timeout_s", 30.0)
    cfg.fleet.health_timeout_s = kw.pop("health_timeout_s", 0.0)
    cfg.fleet.max_engine_restarts = kw.pop("max_engine_restarts", 2)
    for k, v in kw.items():
        setattr(cfg.fleet, k, v)
    return cfg


def _pump(pool, predicate, timeout_s=15.0, desc="condition"):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        pool.poll_once()
        if predicate():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {desc}")


def _spawned(pool, n: int):
    """The pool stepped by hand (no supervise thread)."""
    pool.target = n
    with pool._lock:
        for _ in range(n):
            pool._spawn_new_locked()
    return pool


def test_ready_health_crash_respawn_terminal(tmp_path):
    cfg = _fleet_cfg(tmp_path, max_engine_restarts=1)
    pool = _spawned(EnginePool(cfg, spawn_fn=_stub_spawn(_HEALTHY_STUB)), 2)
    try:
        _pump(pool, lambda: pool.counts()["alive"] == 2
              and len(pool.endpoints()) == 2
              and all(h.state == "alive" for h in pool._engines.values()),
              desc="both stubs alive via healthz")
        status = pool.status()
        assert status["engines"]["e0"]["params_step"] == 3
        assert status["engines"]["e0"]["queue_depth"] == 1
        assert json.loads((tmp_path / "fleet" / "engine_pool.json")
                          .read_text())["target"] == 2
        h0 = pool._engines["e0"]
        pid0 = h0.pid
        h0.proc.kill()
        _pump(pool, lambda: pool.restarts_total == 1
              and pool._engines["e0"].state == "alive"
              and pool._engines["e0"].pid != pid0,
              desc="e0 respawned and healthy")
        assert pool._engines["e0"].streak == 0
        pool._spawn_fn = _stub_spawn("raise SystemExit(9)")
        pool._engines["e0"].proc.kill()
        _pump(pool, lambda: pool._engines["e0"].state == "failed",
              desc="e0 terminally failed")
        assert pool._engines["e1"].state == "alive"
        assert pool.counts()["failed"] == 1
        assert set(pool.endpoints()) == {"e1"}
    finally:
        pool.kill_all()
        pool.stop(grace_s=2.0)


def test_startup_timeout_kills_a_wedged_bringup(tmp_path):
    cfg = _fleet_cfg(tmp_path, num_engines=1, startup_timeout_s=0.3,
                     max_engine_restarts=0)
    pool = _spawned(EnginePool(
        cfg, spawn_fn=_stub_spawn("import time; time.sleep(60)")), 1)
    try:
        _pump(pool, lambda: pool._engines["e0"].state == "failed",
              desc="wedged bring-up killed and failed terminally")
        assert pool.restarts_total == 1
    finally:
        pool.kill_all()
        pool.stop(grace_s=2.0)


def test_quiesced_exit_retires(tmp_path):
    cfg = _fleet_cfg(tmp_path, num_engines=1)
    pool = _spawned(EnginePool(cfg, spawn_fn=_stub_spawn(_HEALTHY_STUB)), 1)
    try:
        _pump(pool, lambda: pool.counts()["alive"] == 1, desc="stub alive")
        pool.quiesce()
        pool._engines["e0"].proc.kill()
        _pump(pool, lambda: pool._engines["e0"].state == "retired",
              desc="quiesced exit retires, not crashes")
        assert pool.restarts_total == 0
        pool.scale(3)                       # refused while quiesced
        assert pool.target == 1
    finally:
        pool.kill_all()
        pool.stop(grace_s=2.0)


def test_worker_command_names_the_device(tmp_path, monkeypatch):
    """Without a spawn seam the pool runs the port's ``cli serve --listen``
    on the pool's device, each worker on its own data dir, all on one
    shared spill arena."""
    cfg = _fleet_cfg(tmp_path, num_engines=1)
    cfg.serve.spill_bytes, cfg.serve.warm_bytes = 1 << 20, 1 << 20
    seen = []

    class _Proc:
        pid = 4242

        def poll(self):
            return None

    monkeypatch.setattr(subprocess, "Popen",
                        lambda cmd, **kw: seen.append(cmd) or _Proc())
    pool = EnginePool(cfg, device="cuda")
    with pool._lock:
        pool._spawn_new_locked()
    cmd = seen[0]
    assert cmd[1:4] == ["-m", "sharetrade_tpu_torch.cli", "serve"]
    assert cmd[cmd.index("--device") + 1] == "cuda"
    assert cmd[cmd.index("--listen") + 1] == "127.0.0.1:0"
    assert f"serve.spill_dir={tmp_path / 'fleet' / 'spill'}" in cmd
    assert any(a.startswith("data.journal_dir=") and a.endswith("e0-data")
               for a in cmd)
    saved = json.loads((tmp_path / "fleet" / "engine_config.json")
                       .read_text())
    assert saved["obs"]["enabled"] is False


def test_backoff_schedule_equals_the_jax_pool(tmp_path):
    """Same config and seed: the port pool's and the JAX pool's ladders
    draw the same respawn delays, streak by streak."""
    port = EnginePool(_fleet_cfg(tmp_path / "p", max_engine_restarts=6,
                                 engine_backoff_jitter=0.3),
                      spawn_fn=_stub_spawn(_HEALTHY_STUB))
    ref = JEnginePool(_fleet_cfg(tmp_path / "j", cls=JFrameworkConfig,
                                 max_engine_restarts=6,
                                 engine_backoff_jitter=0.3),
                      spawn_fn=_stub_spawn(_HEALTHY_STUB))
    got = [ladder.crash_step(s, port._policy, port._rng) for s in range(1, 9)]
    want = [jladder.crash_step(s, ref._policy, ref._rng)
            for s in range(1, 9)]
    assert got == want
    assert got[-1] == (ladder.FAILED, 0.0)
    assert [state for state, _ in got[:6]] == [ladder.BACKOFF] * 6


@pytest.mark.parametrize("seed", range(4))
def test_crash_step_equals_the_jax_function(seed):
    rng = random.Random(seed)
    policy = dict(max_restarts=rng.randrange(0, 6),
                  backoff_initial_s=rng.uniform(0.01, 2.0),
                  backoff_max_s=rng.uniform(0.5, 20.0),
                  backoff_jitter=rng.uniform(0.0, 0.5))
    port_rng, jax_rng = random.Random(seed), random.Random(seed)
    for streak in range(1, 10):
        assert ladder.crash_step(streak, ladder.LadderPolicy(**policy),
                                 port_rng) == \
            jladder.crash_step(streak, jladder.LadderPolicy(**policy),
                               jax_rng)
    assert (ladder.STARTING, ladder.ALIVE, ladder.BACKOFF, ladder.FAILED,
            ladder.RETIRING, ladder.RETIRED, ladder.LIVE_STATES) == \
        (jladder.STARTING, jladder.ALIVE, jladder.BACKOFF, jladder.FAILED,
         jladder.RETIRING, jladder.RETIRED, jladder.LIVE_STATES)


def _rows(rng: np.random.Generator, n: int) -> list[dict]:
    rows = []
    for i in range(n):
        row = {"ts": 1000.0 + i}
        if rng.random() < 0.8:
            row["fleet_slo_availability_burn"] = float(
                rng.choice([0.0, 0.1, 0.5, 1.5, 3.0]))
        if rng.random() < 0.8:
            row["fleet_queue_depth"] = float(rng.integers(0, 40))
        row["fleet_engines_live"] = float(rng.integers(1, 5))
        if rng.random() < 0.5:
            row["fleet_overload"] = float(rng.random() < 0.3)
        rows.append(row)
    return rows


class _StubPool:
    def __init__(self, target: int):
        self.target = target
        self.scaled = []

    def scale(self, n: int) -> None:
        self.target = n
        self.scaled.append(n)

    def live_count(self) -> int:
        return self.target


@pytest.mark.parametrize("seed", range(3))
def test_autoscaler_decides_and_steps_as_the_jax_one(tmp_path, seed):
    rng = np.random.default_rng(seed)
    knobs = dict(num_engines=4, min_engines=1, max_engines=5,
                 autoscale_window=int(rng.integers(2, 5)),
                 autoscale_cooldown_s=2.0, autoscale_interval_s=1.0)
    port = EngineAutoscaler(_StubPool(2), FleetConfig(**knobs),
                            workdir=str(tmp_path / "p"), clock=lambda: 0.0)
    ref = JAutoscaler(_StubPool(2), JFleetConfig(**knobs),
                      workdir=str(tmp_path / "j"), clock=lambda: 0.0)
    for _ in range(40):
        rows = _rows(rng, int(rng.integers(0, 14)))
        current = int(rng.integers(1, 6))
        assert port.decide(rows, current) == ref.decide(rows, current)
    # step(): the same rows through a fake clock, cooldown included.
    stream = _rows(rng, 60)
    for t in range(1, 30):
        window = stream[:2 * t]
        a = port.step(now=float(t), rows=window)
        b = ref.step(now=float(t), rows=window)
        assert (a is None) == (b is None)
        if a is not None:
            assert tuple(a) == tuple(b)
    assert port.pool.scaled == ref.pool.scaled != []
    state = json.loads((tmp_path / "p" / "fleet_autoscale.json").read_text())
    assert state["decisions"] == ref.decisions


def test_autoscaler_reads_the_router_history_ring(tmp_path):
    ring = TsdbRing(str(tmp_path / FLEET_HISTORY_FILE), max_rows=4)
    for i in range(10):
        ring.append({"ts": float(i), "fleet_queue_depth": 50.0,
                     "fleet_engines_live": 1.0})
    ring.close()
    (tmp_path / FLEET_HISTORY_FILE).open("a").write('{"torn": ')
    scaler = EngineAutoscaler(_StubPool(1), FleetConfig(
        num_engines=3, autoscale_window=2), workdir=str(tmp_path),
        clock=lambda: 0.0)
    rows = scaler.read_rows()
    assert [r["ts"] for r in rows] == [6.0, 7.0, 8.0, 9.0]
    applied = scaler.step(now=5.0)
    assert applied is not None and applied.action == "up"
    assert scaler.pool.target == 2


def _env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    return env


def test_cli_fleet_on_the_cpu_serves_and_drains(tmp_path):
    out_path = tmp_path / "fleet.out"
    with open(out_path, "wb") as out, open(tmp_path / "fleet.err",
                                           "wb") as err:
        proc = subprocess.Popen(
            [sys.executable, "-m", "sharetrade_tpu_torch.cli", "fleet",
             "--device", "cpu", "--engines", "1"],
            stdout=out, stderr=err, cwd=tmp_path, env=_env())
    try:
        ready = None
        deadline = time.monotonic() + 90.0
        while ready is None and time.monotonic() < deadline:
            assert proc.poll() is None, (tmp_path / "fleet.err").read_text()
            for line in out_path.read_text().splitlines():
                if '"fleet_ready"' in line:
                    ready = json.loads(line)
            time.sleep(0.1)
        assert ready is not None and ready["engines"] == 1
        assert ready["device"] == "cpu" and ready["proto_backend"] == "py"
        client = FleetClient(ready["host"], ready["port"])
        rng = np.random.default_rng(0)
        for i in range(4):
            reply = client.submit(f"c{i % 2}", rng.uniform(
                1.0, 2.0, 203).astype(np.float32))
            assert reply["engine"] == "e0" and len(reply["logits"]) == 3
        client.close()
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(60.0) == 75
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    summary = json.loads(out_path.read_text().splitlines()[-1])
    assert summary["requests"] == summary["completed"] == 4
    assert summary["refused"] == summary["unrouted"] == 0
    assert summary["preempted"] is True and summary["engines_retired"] == 1
    worker = [json.loads(line) for line in
              (tmp_path / "fleet" / "e0.log").read_text().splitlines()
              if line.startswith("{")]
    assert worker[0]["event"] == "serving_ready"
    assert worker[-1]["mode"] == "listen" and worker[-1]["requests"] == 4
    assert worker[-1]["drained"] and worker[-1]["stopped_clean"]
